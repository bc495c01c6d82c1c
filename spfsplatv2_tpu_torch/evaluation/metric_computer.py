"""Offline metric re-computation over dumped image directories (torch
port of `spfsplatv2_tpu/evaluation/metric_computer.py`).

Re-scores the saved renderings of one or more methods against the
ground-truth dumps (PSNR, SSIM and, given an LPIPS module, LPIPS), writes
`<root>/metric_computer.json` and, optionally, side-by-side comparison
sheets under `<root>/comparisons/<method>/<scene>/`.

Expected layout: <root>/<method>/<scene>/<frame>.png and
<root>/gt/<scene>/<frame>.png.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from spfsplatv2_tpu_torch.evaluation.metrics import (
    compute_lpips,
    compute_psnr,
    compute_ssim,
)


def _load_image(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


@torch.no_grad()
def compute_metrics_for_methods(
    root: str | Path,
    methods: list[str],
    gt_dir: str = "gt",
    lpips=None,
    save_comparison: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """-> {method: {"psnr", "ssim", "lpips" (means or None),
    "num_images"}}; `lpips` is a `losses.lpips.LPIPS` on `device`."""
    from spfsplatv2_tpu_torch.evaluation.evaluator import disable_tf32
    from spfsplatv2_tpu_torch.utils.visualization import hcat, save_image

    disable_tf32()
    root = Path(root)
    results: dict = {}
    for method in methods:
        scores = {"psnr": [], "ssim": [], "lpips": []}
        for scene_dir in sorted((root / gt_dir).iterdir()):
            if not scene_dir.is_dir():
                continue
            for gt_path in sorted(scene_dir.glob("*.png")):
                pred_path = root / method / scene_dir.name / gt_path.name
                if not pred_path.exists():
                    continue
                gt_np, pred_np = _load_image(gt_path), _load_image(pred_path)
                gt = torch.as_tensor(gt_np, device=device)[None]
                pred = torch.as_tensor(pred_np, device=device)[None]
                scores["psnr"].append(float(compute_psnr(gt, pred)[0]))
                scores["ssim"].append(float(compute_ssim(gt, pred)[0]))
                if lpips is not None:
                    scores["lpips"].append(
                        float(compute_lpips(lpips, gt, pred)[0]))
                if save_comparison:
                    save_image(hcat(gt_np, pred_np),
                               root / "comparisons" / method / scene_dir.name
                               / gt_path.name)
        results[method] = {
            k: (float(np.mean(v)) if v else None) for k, v in scores.items()
        }
        results[method]["num_images"] = len(scores["psnr"])
    (root / "metric_computer.json").write_text(json.dumps(results, indent=2))
    return results
