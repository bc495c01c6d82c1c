"""Pose-only evaluator: feed-forward + PnP-from-pointmap baselines (torch
port of `spfsplatv2_tpu/evaluation/pose_evaluator.py`).

For each evaluation example the encoder runs on the CONTEXT views only;
its predicted poses are scored against GT, poses are also recovered by
PnP-RANSAC on the predicted pointmap and opacities (`utils/pnp.py`, the
native solver), and AUC@{5,10,20} + medians are dumped.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from spfsplatv2_tpu_torch.evaluation.evaluator import disable_tf32
from spfsplatv2_tpu_torch.evaluation.metrics import (
    compute_pose_error,
    pose_auc_summary,
)
from spfsplatv2_tpu_torch.utils.pnp import pnp_pose_from_pointmap


@dataclass
class PoseEvalResult:
    ff_rot: list
    ff_transl: list
    pnp_rot: list
    pnp_transl: list

    def summary(self) -> dict:
        out = {}
        for name, rot, tr in (
            ("feed_forward", self.ff_rot, self.ff_transl),
            ("pnp", self.pnp_rot, self.pnp_transl),
        ):
            if rot:
                out[name] = pose_auc_summary(
                    np.asarray(rot, np.float64), np.asarray(tr, np.float64)
                )
        return out


@torch.no_grad()
def evaluate_poses(encoder, examples, opacity_threshold: float = 0.3) -> PoseEvalResult:
    """examples: iterable of dataset examples (context with GT extrinsics)."""
    device = next(encoder.parameters()).device
    disable_tf32()
    result = PoseEvalResult([], [], [], [])
    for example in examples:
        ctx = example["context"]

        def batch1(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)[None]

        ctx_img, ctx_k = batch1(ctx["image"]), batch1(ctx["intrinsics"])
        out = encoder(ctx_img, ctx_k)
        v = ctx_img.shape[1]

        gt = batch1(ctx["extrinsics"])[0]
        # Feed-forward pose error on non-anchor views (view 0 is identity).
        rot, tr = compute_pose_error(out["extrinsics_c"][0, 1:], gt[1:])
        result.ff_rot.extend(float(x) for x in rot.cpu())
        result.ff_transl.extend(float(x) for x in tr.cpu())

        pts3d = out["pts3d"][0].cpu().numpy()       # (v, h, w, 3)
        dens = out["densities"][0].cpu().numpy()    # (v, h, w)
        for i in range(1, v):
            c2w = pnp_pose_from_pointmap(
                pts3d[i], dens[i], np.asarray(ctx["intrinsics"][i]),
                opacity_threshold,
            )
            rot, tr = compute_pose_error(
                torch.as_tensor(c2w, device=device)[None], gt[i: i + 1])
            result.pnp_rot.append(float(rot[0]))
            result.pnp_transl.append(float(tr[0]))
    return result


def dump_pose_eval(result: PoseEvalResult, output_path: str | Path) -> dict:
    out_dir = Path(output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = result.summary()
    (out_dir / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    return summary
