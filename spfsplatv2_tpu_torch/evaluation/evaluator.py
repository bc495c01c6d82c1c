"""Test-set evaluation of one scene: novel-view synthesis + pose metrics.

Torch port of `spfsplatv2_tpu/evaluation/evaluator.py:evaluate_example`,
the serving path of `python -m spfsplatv2_tpu.main mode=test`:
  * per-target encoding (the published protocol: context + ONE target per
    encoder call) or joint encoding;
  * rendering the targets at the predicted poses with GT intrinsics;
  * PSNR / SSIM and pose errors.
Test-time pose alignment needs the backward compositing kernel and LPIPS
is not ported, so `align_pose=True` and `lpips_params` raise; so do image
and video saving.

The whole path runs under `torch.no_grad()` with TF32 off for matmuls and
cuDNN convolutions (`disable_tf32`), so float32 stays float32 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from spfsplatv2_tpu_torch.evaluation.benchmarker import Benchmarker
from spfsplatv2_tpu_torch.evaluation.metrics import (
    compute_pose_error,
    compute_psnr,
    compute_ssim,
)
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting


@dataclass
class EvalConfig:
    """The switches of the JAX EvalConfig that this slice reads; the pose
    alignment's steps and rate and the output path come back with the
    features that use them."""

    align_pose: bool = False
    save_images: bool = False
    save_video: bool = False
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
    benchmarker: Optional[Benchmarker] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Evaluate ONE scene: all target views rendered at predicted poses.

    `example` holds numpy arrays or tensors: context/target "image"
    (v, h, w, 3), "intrinsics" (v, 3, 3), target "near"/"far" (v,), and
    optionally "extrinsics" (v, 4, 4) and context "overlap".
    """
    if eval_cfg.align_pose:
        raise NotImplementedError(
            "align_pose needs the backward compositing kernel (K2), which "
            "lands with the training slice"
        )
    if lpips_params is not None:
        raise NotImplementedError("LPIPS is not ported yet")
    if eval_cfg.save_images or eval_cfg.save_video:
        raise NotImplementedError("image and video saving is not ported yet")
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

    if eval_cfg.per_target_encoding:
        colors, poses_out, dropped = [], [], []
        for t in range(v_tgt):
            sl = slice(t, t + 1)
            with bench.time("encoder"):
                out = encoder(ctx_img, ctx_k, tgt_img[:, sl], tgt_k[:, sl])
            pose_t = out["extrinsics_cwt"][:, v_cxt:]
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
        pred_tgt_poses = out["extrinsics_cwt"][:, v_cxt:]
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
    result["rendered"] = pred
    return result
