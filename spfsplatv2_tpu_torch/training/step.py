"""Training step: encoder -> render -> losses -> AdamW update (torch port of
`spfsplatv2_tpu/training/step.py`).

`compute_losses` is the JAX function's forward and losses (MSE, LPIPS,
reprojection of the predicted context poses, view-validity masks,
`training_context`, the dropped-entries counter and the pose telemetry).
`make_train_step` returns `step(state, batch) -> (state, metrics)`: the
backward pass, optionally accumulated over equal microbatches, then one
update of `training/optim.py:Optimizer`.  PyTorch updates the parameters
in place, so the state holds the encoder and the optimizer.  The
distillation branch, the SPFSplat v1 branch and the multi-device branch
are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.evaluation.evaluator import disable_tf32
from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.losses.lpips import lpips_distances, lpips_loss
from spfsplatv2_tpu_torch.losses.mse import mse_loss
from spfsplatv2_tpu_torch.losses.reproj import ReprojConfig, reproj_loss
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting
from spfsplatv2_tpu_torch.training.optim import Optimizer


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


@dataclass
class TrainState:
    """`step` counts every step taken, skipped ones included."""

    step: int
    encoder: torch.nn.Module
    optimizer: Optimizer


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
    distiller=None,
) -> tuple[torch.Tensor, dict]:
    """Forward + all training losses: (total loss, metrics of 0-d tensors).

    `batch` holds "context" and "target" dicts of (b, v, ...) tensors
    ("image", "intrinsics", "near", "far", optionally "extrinsics") and
    optionally "context_valid" / "target_valid" (v,) view masks.
    """
    if distiller is not None:
        raise NotImplementedError("pointmap distillation is not ported yet")
    ctx, tgt = batch["context"], batch["target"]
    v_cxt = ctx["image"].shape[1]
    ctx_valid = batch.get("context_valid")
    tgt_valid = batch.get("target_valid")

    enc_kwargs = {}
    if ctx_valid is not None or tgt_valid is not None:
        enc_kwargs = dict(context_valid=ctx_valid, target_valid=tgt_valid)
    enc_out = encoder(ctx["image"], ctx["intrinsics"], tgt["image"],
                      tgt["intrinsics"], global_step=global_step, **enc_kwargs)
    if enc_out.get("variant") == "spfsplat":
        raise NotImplementedError("the SPFSplat v1 loss branch is not ported yet")

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
        if "extrinsics" in ctx:
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


def make_train_step(
    encoder,
    optimizer: Optimizer,
    image_shape: tuple[int, int],
    decoder_cfg: DecoderConfig = DecoderConfig(),
    loss_cfg: LossConfig = LossConfig(),
    lpips=None,
    training_context: bool = False,
    distiller=None,
    microbatch: int | None = None,
    mesh=None,
):
    """Build `step(state, batch) -> (state, metrics)`.

    `microbatch`: gradient accumulation over equal chunks of this size;
    the gradient is the mean of the chunks' gradients (equal chunks: the
    full batch's), float metrics are averaged and integer counters summed,
    and ONE optimizer update is applied.  Metrics come back as Python
    numbers, with "grad/max" and "grad/skipped_steps" from the optimizer.
    """
    if distiller is not None:
        raise NotImplementedError("pointmap distillation is not ported yet")
    if mesh is not None:
        raise NotImplementedError("multi-device training is not ported yet")
    disable_tf32()

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        b = batch["context"]["image"].shape[0]
        n = 1
        if microbatch is not None and microbatch < b:
            if b % microbatch:
                raise ValueError(f"batch {b} is not a multiple of microbatch "
                                 f"{microbatch}")
            n = b // microbatch
        state.encoder.train()
        optimizer.zero_grad()
        sums = {}
        for mb in _split(batch, n):
            loss, metrics = compute_losses(
                state.encoder, mb, state.step, image_shape, decoder_cfg,
                loss_cfg, lpips, training_context)
            (loss / n).backward()
            for k, m in metrics.items():
                sums[k] = sums.get(k, 0) + m
        metrics = {k: (float(m) / n if m.is_floating_point() else int(m))
                   for k, m in sums.items()}
        optimizer.step()
        metrics["grad/max"] = optimizer.last_max_grad
        metrics["grad/skipped_steps"] = optimizer.skipped_count
        state.step += 1
        return state, metrics

    return step


class HBMBudgetError(RuntimeError):
    """The train step's peak device memory exceeds the budget."""


def init_train_state(encoder, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, encoder=encoder, optimizer=optimizer)
