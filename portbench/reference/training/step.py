"""The training step, plain: a frozen copy of the port's
`training/step.py` (`compute_losses`: MSE, LPIPS and reprojection losses,
pose telemetry) without its data-parallel and teacher branches, and
`train_step`, one update over equal microbatches as `make_train_step`
takes it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from portbench.reference.geometry import se3
from portbench.reference.losses.lpips import lpips_distances, lpips_loss
from portbench.reference.losses.mse import mse_loss
from portbench.reference.losses.reproj import ReprojConfig, reproj_loss
from portbench.reference.models.decoder import DecoderConfig, decode_splatting
from portbench.reference.training.optim import Optimizer


@dataclass(frozen=True)
class LossConfig:
    mse_weight: float = 1.0
    lpips_weight: float = 0.05
    lpips_apply_after_step: int = 0
    reproj: ReprojConfig = field(default_factory=ReprojConfig)
    use_lpips: bool = True
    # An `lpips.LPIPS(net="vgg")` state_dict file (`losses/lpips.py:
    # get_lpips`); None = seeded random VGG features.
    lpips_weights_path: str | None = None


def psnr(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((prediction - target) ** 2, dim=(-1, -2, -3))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _weighted_mean(per_img: torch.Tensor, img_w: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_img * img_w) / torch.clamp(torch.sum(img_w), min=1.0)


def compute_losses(
    encoder,
    batch: dict,
    global_step: int,
    image_shape: tuple[int, int],
    decoder_cfg: DecoderConfig = DecoderConfig(),
    loss_cfg: LossConfig = LossConfig(),
    lpips=None,
    training_context: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Forward + all training losses: (total loss, metrics of 0-d tensors).

    `batch` holds "context" and "target" dicts of (b, v, ...) tensors
    ("image", "intrinsics", "near", "far", optionally "extrinsics") and
    optionally "context_valid" / "target_valid" (v,) view masks.
    """
    ctx, tgt = batch["context"], batch["target"]
    v_cxt = ctx["image"].shape[1]
    ctx_valid = batch.get("context_valid")
    tgt_valid = batch.get("target_valid")

    enc_kwargs = {}
    if ctx_valid is not None or tgt_valid is not None:
        enc_kwargs = dict(context_valid=ctx_valid, target_valid=tgt_valid)
    enc_out = encoder(ctx["image"], ctx["intrinsics"], tgt["image"],
                      tgt["intrinsics"], global_step=global_step, **enc_kwargs)

    if enc_out["extrinsics_cwt"] is not None:
        target_extrinsics = enc_out["extrinsics_cwt"][:, v_cxt:]
        context_extrinsics = enc_out["extrinsics_cwt"][:, :v_cxt]
    else:
        target_extrinsics = tgt["extrinsics"]
        context_extrinsics = ctx["extrinsics"]

    if training_context:
        render_extr = torch.cat([context_extrinsics, target_extrinsics], 1)
        render_intr = torch.cat([ctx["intrinsics"], tgt["intrinsics"]], 1)
        near = torch.cat([ctx["near"], tgt["near"]], 1)
        far = torch.cat([ctx["far"], tgt["far"]], 1)
        target_gt = torch.cat([ctx["image"], tgt["image"]], 1)
    else:
        render_extr, render_intr = target_extrinsics, tgt["intrinsics"]
        near, far, target_gt = tgt["near"], tgt["far"], tgt["image"]

    dec_out = decode_splatting(enc_out["gaussians"], render_extr, render_intr,
                               near, far, image_shape, decoder_cfg)
    b, v = target_gt.shape[:2]
    pred_flat = dec_out.color.reshape(b * v, *dec_out.color.shape[2:])
    gt_flat = target_gt.reshape(b * v, *target_gt.shape[2:])

    # Per-rendered-image weights from the dropout masks.
    img_w = None
    dt = pred_flat.dtype
    if tgt_valid is not None:
        w = tgt_valid.to(dt)
        if training_context:
            cv = (torch.ones((v_cxt,), dtype=dt, device=w.device)
                  if ctx_valid is None else ctx_valid.to(dt))
            w = torch.cat([cv, w])
        img_w = w.repeat(b)

    metrics = {}
    if dec_out.dropped_entries is not None:
        metrics["raster/dropped_entries"] = torch.sum(dec_out.dropped_entries)
    if img_w is None:
        total = mse_loss(pred_flat, gt_flat, loss_cfg.mse_weight)
    else:
        per_img = torch.mean((pred_flat - gt_flat) ** 2, dim=(1, 2, 3))
        total = loss_cfg.mse_weight * _weighted_mean(per_img, img_w)
    metrics["loss/mse"] = total

    if loss_cfg.use_lpips and lpips is not None:
        if img_w is None:
            lp = lpips_loss(lpips, pred_flat, gt_flat, loss_cfg.lpips_weight)
        else:
            lp = loss_cfg.lpips_weight * _weighted_mean(
                lpips_distances(lpips, pred_flat, gt_flat), img_w)
        if global_step < loss_cfg.lpips_apply_after_step:
            lp = torch.zeros_like(lp)
        metrics["loss/lpips"] = lp
        total = total + lp

    # Reprojection consistency of the predicted context poses.
    if enc_out["extrinsics_cwt"] is not None:
        pts3d = enc_out["pts3d"]
        c1 = reproj_loss(pts3d[:, 0], context_extrinsics[:, 0],
                         ctx["intrinsics"][:, 0], global_step, loss_cfg.reproj)
        n_kept = (float(v_cxt) if ctx_valid is None
                  else torch.clamp(ctx_valid.to(torch.float32).sum(), min=1.0))
        c2 = 0.0
        for i in range(1, v_cxt):
            term = reproj_loss(pts3d[:, i], context_extrinsics[:, i],
                               ctx["intrinsics"][:, i], global_step,
                               loss_cfg.reproj)
            if ctx_valid is not None:
                term = term * ctx_valid[i].to(term.dtype)
            c2 = c2 + term
        c2 = c2 / n_kept
        metrics["loss/reproj_c1"] = c1
        metrics["loss/reproj_c2"] = c2
        total = total + c1 + c2
    # Pose error against GT (telemetry, not a loss).
    if enc_out["extrinsics_cwt"] is not None and "extrinsics" in ctx:
        with torch.no_grad():
            pred_c = context_extrinsics[:, v_cxt - 1]
            gt_c = ctx["extrinsics"][:, v_cxt - 1]
            metrics["pose/context_rot_deg"] = torch.mean(
                se3.rotation_angle_deg(pred_c[:, :3, :3], gt_c[:, :3, :3]))
            metrics["pose/context_transl_deg"] = torch.mean(
                se3.translation_angle_deg(pred_c[:, :3, 3], gt_c[:, :3, 3]))

    metrics["loss/total"] = total
    metrics["train/psnr"] = torch.mean(psnr(pred_flat, gt_flat))
    return total, {k: torch.as_tensor(m).detach() for k, m in metrics.items()}


def _split(batch: dict, n: int) -> list[dict]:
    """`n` equal microbatches along the batch axis; view masks are shared."""
    parts = [dict() for _ in range(n)]
    for key, val in batch.items():
        if key in ("context", "target"):
            chunks = {k: torch.chunk(t, n, dim=0) for k, t in val.items()}
            for i in range(n):
                parts[i][key] = {k: c[i] for k, c in chunks.items()}
        else:
            for i in range(n):
                parts[i][key] = val
    return parts


def _split(batch: dict, n: int) -> list[dict]:
    """`n` equal microbatches along the batch axis; view masks are shared."""
    parts = [dict() for _ in range(n)]
    for key, val in batch.items():
        if key in ("context", "target"):
            chunks = {k: torch.chunk(t, n, dim=0) for k, t in val.items()}
            for i in range(n):
                parts[i][key] = {k: c[i] for k, c in chunks.items()}
        else:
            for i in range(n):
                parts[i][key] = val
    return parts


def train_step(encoder, optimizer: Optimizer, batch: dict, global_step: int,
               image_shape: tuple[int, int], decoder_cfg: DecoderConfig,
               loss_cfg: LossConfig, lpips, microbatch: int) -> dict:
    """One update: the mean of the microbatches' gradients (equal chunks:
    the full batch's), then one optimizer step; returns the float metrics
    averaged over the microbatches, as `make_train_step` does."""
    n = max(batch["context"]["image"].shape[0] // microbatch, 1)
    encoder.train()
    optimizer.zero_grad()
    sums = {}
    for mb in _split(batch, n):
        loss, metrics = compute_losses(encoder, mb, global_step, image_shape,
                                       decoder_cfg, loss_cfg, lpips)
        (loss / n).backward()
        for k, m in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(m) / n
    optimizer.step()
    return sums
