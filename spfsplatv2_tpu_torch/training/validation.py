"""In-training validation: metrics and a comparison sheet (torch port of
`spfsplatv2_tpu/training/validation.py:run_validation_step`).

Every `trainer.val_check_interval` steps one validation scene is encoded
jointly (context + targets), context AND target views are re-rendered
from the predicted Gaussians at the predicted poses, and
  * val/psnr, val/ssim, val/lpips over the target views,
  * val/context/{psnr,ssim,lpips} over the re-rendered context views,
  * val/{context,target}_angular_error and _transl_error pose errors
are returned, while a labelled comparison sheet (context | context
depth | target GT | prediction | depth) lands in
`<out_dir>/validation/step_<n>/comparison.png`, beside 30-frame
interpolation and wobble videos of the context (`interpolation.gif`,
`wobble.gif`; best effort, as in the JAX function: a failure prints
"validation video skipped: ..." and training goes on).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spfsplatv2_tpu_torch.evaluation.evaluator import disable_tf32
from spfsplatv2_tpu_torch.evaluation.metrics import (
    compute_lpips,
    compute_pose_error,
    compute_psnr,
    compute_ssim,
)
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting
from spfsplatv2_tpu_torch.utils.visualization import (
    apply_depth_colormap,
    hcat,
    save_image,
    vcat,
)


def add_label(image: np.ndarray, label: str) -> np.ndarray:
    """Stamp a tiny 5x3-font label strip above an image."""
    from spfsplatv2_tpu_torch.utils.minifont import render_text

    strip = render_text(label, width=image.shape[1])
    return np.concatenate([strip, np.asarray(image, np.float32)], axis=0)


@torch.no_grad()
def run_validation_step(
    encoder,
    example: dict,
    image_shape: tuple[int, int],
    decoder_cfg: DecoderConfig = DecoderConfig(),
    lpips=None,
    lpips_calibrated: bool = True,
    out_dir: str | Path | None = None,
    step: int = 0,
) -> dict:
    """Validate ONE scene (un-batched numpy example). Returns metric dict."""
    device = next(encoder.parameters()).device
    disable_tf32()
    ctx, tgt = example["context"], example["target"]

    def batch1(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)[None]

    ctx_img, tgt_img = batch1(ctx["image"]), batch1(tgt["image"])
    ctx_k, tgt_k = batch1(ctx["intrinsics"]), batch1(tgt["intrinsics"])
    v_cxt, v_tgt = ctx_img.shape[1], tgt_img.shape[1]

    out = encoder(ctx_img, ctx_k, tgt_img, tgt_k)
    poses_all = out["extrinsics_cwt"]  # (1, v_cxt + v_tgt, 4, 4)

    k_all = torch.cat([ctx_k, tgt_k], dim=1)
    near = torch.cat([batch1(ctx["near"]), batch1(tgt["near"])], dim=1)
    far = torch.cat([batch1(ctx["far"]), batch1(tgt["far"])], dim=1)
    rendered = decode_splatting(out["gaussians"], poses_all, k_all, near, far,
                                image_shape, decoder_cfg)
    pred = rendered.color[0]  # (v_cxt + v_tgt, h, w, 3)
    gt = torch.cat([ctx_img, tgt_img], dim=1)[0]

    metrics: dict[str, float] = {}

    def block(tag, lo, hi):
        metrics[f"{tag}psnr"] = float(torch.mean(compute_psnr(gt[lo:hi], pred[lo:hi])))
        metrics[f"{tag}ssim"] = float(torch.mean(compute_ssim(gt[lo:hi], pred[lo:hi])))
        if lpips is not None:
            # Random VGG weights are labelled so that their scores are
            # never read as published LPIPS numbers.
            key = "lpips" if lpips_calibrated else "lpips_uncalibrated"
            metrics[f"{tag}{key}"] = float(
                torch.mean(compute_lpips(lpips, gt[lo:hi], pred[lo:hi])))

    block("val/", v_cxt, v_cxt + v_tgt)
    block("val/context/", 0, v_cxt)

    if "extrinsics" in tgt:
        rot, tr = compute_pose_error(poses_all[0, v_cxt:],
                                     batch1(tgt["extrinsics"])[0])
        metrics["val/target_angular_error"] = float(torch.mean(rot))
        metrics["val/target_transl_error"] = float(torch.mean(tr))
    if "extrinsics" in ctx:
        # Only the last context view is scored (view 0 is the anchor).
        rot, tr = compute_pose_error(
            poses_all[0, v_cxt - 1: v_cxt],
            batch1(ctx["extrinsics"])[0, v_cxt - 1: v_cxt],
        )
        metrics["val/context_angular_error"] = float(torch.mean(rot))
        metrics["val/context_transl_error"] = float(torch.mean(tr))

    if out_dir is not None:
        step_dir = Path(out_dir) / "validation" / f"step_{step}"
        pred_np = torch.clamp(pred, 0, 1).cpu().numpy()
        gt_np = torch.clamp(gt, 0, 1).cpu().numpy()
        depth_np = rendered.depth[0].cpu().numpy()
        columns = [add_label(vcat(*gt_np[:v_cxt]), "Context")]
        if out.get("depths") is not None:  # per-context-view depth maps
            d = out["depths"][0].cpu().numpy()
            columns.append(add_label(
                vcat(*[apply_depth_colormap(d[i]) for i in range(v_cxt)]),
                "Context Depth"))
        columns += [
            add_label(vcat(*gt_np[v_cxt:]), "Target (Ground Truth)"),
            add_label(vcat(*pred_np[v_cxt:]), "Prediction"),
            add_label(
                vcat(*[apply_depth_colormap(depth_np[v_cxt + i])
                       for i in range(v_tgt)]),
                "Depth",
            ),
        ]
        save_image(hcat(*columns), step_dir / "comparison.png")

        from spfsplatv2_tpu_torch.evaluation.video import (
            render_interpolation_video,
            render_wobble_video,
        )

        try:
            for name, render_fn in (("interpolation",
                                     render_interpolation_video),
                                    ("wobble", render_wobble_video)):
                render_fn(encoder, ctx, image_shape, num_frames=30,
                          decoder_cfg=decoder_cfg,
                          output_path=step_dir / f"{name}.gif")
        except Exception as e:  # video is best-effort during training
            print(f"validation video skipped: {e}", flush=True)
    return metrics
