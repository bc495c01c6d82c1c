"""Test-set evaluator: novel-view synthesis + pose metrics over fixed
indices (torch port of `spfsplatv2_tpu/evaluation/evaluator.py`), the
serving path of `python -m spfsplatv2_tpu_torch.main mode=test`:
  * per-target encoding (the published protocol: context + ONE target per
    encoder call) or joint encoding;
  * optional test-time pose alignment through the renderer
    (`pose_align.align_poses`, kernel K2 on the card);
  * rendering the targets at the predicted poses with GT intrinsics;
  * PSNR / SSIM / LPIPS and pose errors, bucketed by context overlap;
  * artifacts: `<output_path>/<scene>/color/<index:06>.png` per target
    view, with `save_video` the target frames as
    `<output_path>/video/<scene>_frame_<context indices joined by _>.gif`,
    and `summarize_and_dump`'s `scores_all.json`,
    `scores_all_avg.json`, `scores_sub_avg.json` (per-overlap buckets),
    `benchmark.json` and `peak_memory.json`.
`use_estimated_focal` is not ported and raises.

The path runs under `torch.no_grad()` (the pose alignment enables
autograd for itself) with TF32 off for matmuls and cuDNN convolutions
(`disable_tf32`), so float32 stays float32 on the card.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from spfsplatv2_tpu_torch.evaluation.benchmarker import Benchmarker
from spfsplatv2_tpu_torch.evaluation.metrics import (
    compute_lpips,
    compute_pose_error,
    compute_psnr,
    compute_ssim,
    pose_auc_summary,
)
from spfsplatv2_tpu_torch.evaluation.pose_align import align_poses
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting


@dataclass
class EvalConfig:
    align_pose: bool = False
    pose_align_steps: int = 100
    opt_lr: float = 5e-4
    save_images: bool = False
    save_video: bool = False
    output_path: str = "outputs/test"
    per_target_encoding: bool = True
    use_estimated_focal: bool = False


def disable_tf32() -> None:
    """Full float32 for matmuls and cuDNN convolutions (the DPT heads'
    convolutions otherwise run in TF32 through cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def get_overlap_tag(overlap: float) -> str:
    """Context-overlap bucket."""
    if 0.05 <= overlap <= 0.3:
        return "small"
    if overlap <= 0.55:
        return "medium"
    if overlap <= 0.8:
        return "large"
    return "ignore"


def _floats(x: torch.Tensor) -> list[float]:
    return [float(v) for v in x.detach().cpu().reshape(-1)]


@torch.no_grad()
def evaluate_example(
    encoder,
    example: dict,
    image_shape: tuple[int, int],
    decoder_cfg: DecoderConfig = DecoderConfig(),
    eval_cfg: EvalConfig = EvalConfig(),
    lpips_params=None,
    lpips_calibrated: bool = True,
    benchmarker: Optional[Benchmarker] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Evaluate ONE scene: all target views rendered at predicted poses.

    `example` holds numpy arrays or tensors: context/target "image"
    (v, h, w, 3), "intrinsics" (v, 3, 3), target "near"/"far" (v,), and
    optionally "extrinsics" (v, 4, 4) and context "overlap".
    `lpips_params` is a `losses.lpips.LPIPS` module; its score is stored
    as "lpips", or "lpips_uncalibrated" unless `lpips_calibrated`.
    """
    if eval_cfg.use_estimated_focal:
        raise NotImplementedError("use_estimated_focal is not ported yet")
    device = torch.device(device)
    disable_tf32()
    bench = benchmarker or Benchmarker(device)
    ctx, tgt = example["context"], example["target"]

    def batch1(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)[None]

    ctx_img, tgt_img = batch1(ctx["image"]), batch1(tgt["image"])
    ctx_k, tgt_k = batch1(ctx["intrinsics"]), batch1(tgt["intrinsics"])
    near, far = batch1(tgt["near"]), batch1(tgt["far"])
    v_cxt, v_tgt = ctx_img.shape[1], tgt_img.shape[1]

    def render_targets(gaussians, poses, intr, near_, far_):
        return decode_splatting(gaussians, poses, intr, near_, far_,
                                image_shape, decoder_cfg)

    def align(gaussians, poses, intr, near_, far_, images):
        if not eval_cfg.align_pose:
            return poses
        with bench.time("pose_optimize"):
            poses, _ = align_poses(gaussians, poses, intr, near_, far_, images,
                                   image_shape, steps=eval_cfg.pose_align_steps,
                                   lr=eval_cfg.opt_lr, decoder_cfg=decoder_cfg)
        return poses

    if eval_cfg.per_target_encoding:
        colors, poses_out, dropped = [], [], []
        for t in range(v_tgt):
            sl = slice(t, t + 1)
            with bench.time("encoder"):
                out = encoder(ctx_img, ctx_k, tgt_img[:, sl], tgt_k[:, sl])
            pose_t = align(out["gaussians"], out["extrinsics_cwt"][:, v_cxt:],
                           tgt_k[:, sl], near[:, sl], far[:, sl], tgt_img[:, sl])
            with bench.time("decoder", num_calls=1):
                rendered = render_targets(out["gaussians"], pose_t,
                                          tgt_k[:, sl], near[:, sl], far[:, sl])
            colors.append(rendered.color)
            poses_out.append(pose_t)
            dropped.append(rendered.dropped_entries)
        pred = torch.cat(colors, dim=1)[0]
        pred_tgt_poses = torch.cat(poses_out, dim=1)
        dropped_entries = torch.cat(dropped, dim=1)
    else:
        with bench.time("encoder"):
            out = encoder(ctx_img, ctx_k, tgt_img, tgt_k)
        pred_tgt_poses = align(out["gaussians"], out["extrinsics_cwt"][:, v_cxt:],
                               tgt_k, near, far, tgt_img)
        with bench.time("decoder", num_calls=v_tgt):
            rendered = render_targets(out["gaussians"], pred_tgt_poses, tgt_k,
                                      near, far)
        pred = rendered.color[0]
        dropped_entries = rendered.dropped_entries
    out_ctx_poses = out["extrinsics_cwt"][:, :v_cxt]

    result = {"scene": example.get("scene", "?")}
    overlap = ctx.get("overlap")
    if overlap is not None:
        result["overlap"] = float(overlap)
        result["overlap_tag"] = get_overlap_tag(float(overlap))
    gt = tgt_img[0]
    result["psnr"] = _floats(compute_psnr(gt, pred))
    result["ssim"] = _floats(compute_ssim(gt, pred))
    if lpips_params is not None:
        # Random VGG weights are labelled so that their scores are never
        # read as published LPIPS numbers.
        key = "lpips" if lpips_calibrated else "lpips_uncalibrated"
        result[key] = _floats(compute_lpips(lpips_params, gt, pred))
    if "extrinsics" in tgt:
        rot, tr = compute_pose_error(pred_tgt_poses[0],
                                     batch1(tgt["extrinsics"])[0])
        result["pose_rot_err_deg"] = _floats(rot)
        result["pose_transl_err_deg"] = _floats(tr)
    if "extrinsics" in ctx:
        rot, tr = compute_pose_error(out_ctx_poses[0],
                                     batch1(ctx["extrinsics"])[0])
        result["context_pose_rot_err_deg"] = _floats(rot)
        result["context_pose_transl_err_deg"] = _floats(tr)
    result["dropped_entries"] = [int(x) for x in dropped_entries.reshape(-1)]
    result["images"] = None
    if eval_cfg.save_images or eval_cfg.save_video:
        from spfsplatv2_tpu_torch.utils.visualization import (
            save_image,
            save_video,
        )

        frames = torch.clamp(pred, 0, 1).cpu().numpy()
        scene = str(result["scene"])
        out_dir = Path(eval_cfg.output_path)
        if eval_cfg.save_images:
            indices = tgt.get("index", list(range(v_tgt)))
            for i, frame in enumerate(frames):
                save_image(frame,
                           out_dir / scene / "color" / f"{indices[i]:0>6}.png")
            result["images"] = frames
        if eval_cfg.save_video:
            ctx_idx = ctx.get("index", list(range(v_cxt)))
            frame_str = "_".join(str(int(i)) for i in ctx_idx)
            save_video(list(frames),
                       out_dir / "video" / f"{scene}_frame_{frame_str}.gif")
    result["rendered"] = pred
    return result


def summarize_and_dump(
    results: list[dict], output_path: str | Path, benchmarker: Benchmarker
) -> dict:
    """Aggregate per-scene results into the score artifacts."""
    out_dir = Path(output_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    def flat(key, rs=results):
        return [x for r in rs for x in (r.get(key) or [])]

    def averages(rs):
        out = {
            "psnr": float(np.mean(flat("psnr", rs))) if flat("psnr", rs) else None,
            "ssim": float(np.mean(flat("ssim", rs))) if flat("ssim", rs) else None,
            "lpips": (
                float(np.mean(flat("lpips", rs))) if flat("lpips", rs) else None
            ),
            "num_scenes": len(rs),
        }
        if flat("lpips_uncalibrated", rs):
            out["lpips_uncalibrated"] = float(
                np.mean(flat("lpips_uncalibrated", rs))
            )
        rot = np.asarray(flat("pose_rot_err_deg", rs), np.float64)
        tr = np.asarray(flat("pose_transl_err_deg", rs), np.float64)
        if rot.size:
            out["pose"] = pose_auc_summary(rot, tr)
        return out

    summary = averages(results)

    buckets: dict[str, list[dict]] = {}
    for r in results:
        tag = r.get("overlap_tag")
        if tag:
            buckets.setdefault(tag, []).append(r)
    sub_avg = {tag: averages(rs) for tag, rs in sorted(buckets.items())}

    scores_all = [
        {k: v for k, v in r.items() if k not in ("images", "rendered")}
        for r in results
    ]
    (out_dir / "scores_all.json").write_text(json.dumps(scores_all, indent=2))
    (out_dir / "scores_all_avg.json").write_text(json.dumps(summary, indent=2))
    (out_dir / "scores_sub_avg.json").write_text(json.dumps(sub_avg, indent=2))
    benchmarker.dump(out_dir / "benchmark.json")
    benchmarker.dump_memory(out_dir / "peak_memory.json")
    if sub_avg:
        summary["by_overlap"] = sub_avg
    return summary


class RunningMetricTables:
    """Running console metric tables during the test loop: overall + one
    table per context-overlap bucket.

    update() folds one scene's scalar metrics into running means; render()
    returns the formatted tables printed after every scene.
    """

    def __init__(self, method: str = "ours"):
        self.method = method
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._sub_sums: dict[str, dict[str, float]] = {}
        self._sub_counts: dict[str, dict[str, int]] = {}

    @staticmethod
    def _scene_scalars(result: dict) -> dict[str, float]:
        out = {}
        for key in ("psnr", "ssim", "lpips", "lpips_uncalibrated",
                    "pose_rot_err_deg", "pose_transl_err_deg"):
            vals = result.get(key)
            if vals:
                out[key] = float(np.mean(vals))
        return out

    def update(self, result: dict) -> None:
        metrics = self._scene_scalars(result)
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + v
            self._counts[k] = self._counts.get(k, 0) + 1
        tag = result.get("overlap_tag")
        if tag:
            sums = self._sub_sums.setdefault(tag, {})
            counts = self._sub_counts.setdefault(tag, {})
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1

    def means(self, tag: str | None = None) -> dict[str, float]:
        sums = self._sums if tag is None else self._sub_sums.get(tag, {})
        counts = self._counts if tag is None else self._sub_counts.get(tag, {})
        return {k: sums[k] / counts[k] for k in sums}

    @staticmethod
    def _table(means: dict[str, float], method: str) -> str:
        if not means:
            return "(no metrics yet)"
        keys = list(means)
        widths = [max(len(k), 8) for k in keys]
        header = "  ".join(["Method".ljust(8)]
                           + [k.ljust(w) for k, w in zip(keys, widths)])
        row = "  ".join(
            [method.ljust(8)]
            + [f"{means[k]:.3f}".ljust(w) for k, w in zip(keys, widths)]
        )
        return f"{header}\n{row}"

    def render(self) -> str:
        lines = ["All Pairs:", self._table(self.means(), self.method)]
        for tag in sorted(self._sub_sums):
            lines.append(f"Overlap: {tag}")
            lines.append(self._table(self.means(tag), self.method))
        return "\n".join(lines)
