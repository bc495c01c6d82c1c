"""Reprojection consistency loss, the pose self-supervision signal (torch
port of `spfsplatv2_tpu/losses/reproj.py`).

Each view's predicted 3D points are projected with that view's predicted
pose and GT intrinsics; the per-pixel distance to the pixel grid is
penalised with a (dynamically scheduled) tanh soft clamp, and pixels past
the hard clamp carry no loss.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.geometry import se3


@dataclass(frozen=True)
class ReprojConfig:
    weight: float = 1e-3
    mode: str = "dyntanh"
    circle_schedule: bool = True
    total_iterations: int = 300_001
    hard_clamp: float = 1000.0
    soft_clamp: float = 50.0
    soft_clamp_min: float = 1.0


def soft_clamp(global_step: int, cfg: ReprojConfig) -> float:
    """The tanh clamp's scale at `global_step`, in float32 as the JAX
    function computes it (near the end of the circle schedule 1 - p^2
    cancels, and float64 would differ by ~1e-4)."""
    if cfg.mode == "tanh":
        return cfg.soft_clamp
    if cfg.mode != "dyntanh":
        raise NotImplementedError(f"reproj mode {cfg.mode!r}")
    one = np.float32(1.0)
    progress = np.float32(min(max(global_step / cfg.total_iterations, 0.0), 1.0))
    if cfg.circle_schedule:
        progress = one - np.sqrt(np.maximum(one - progress * progress,
                                            np.float32(0.0)))
    return float((one - progress) * np.float32(cfg.soft_clamp)
                 + np.float32(cfg.soft_clamp_min))


def reproj_loss(
    pts3d: torch.Tensor,       # (b, h, w, 3) predicted world points
    c2w: torch.Tensor,         # (b, 4, 4) predicted pose of the same view
    intrinsics: torch.Tensor,  # (b, 3, 3) normalized GT intrinsics
    global_step: int,
    cfg: ReprojConfig = ReprojConfig(),
    detach_pts3d: bool = False,
) -> torch.Tensor:
    """`detach_pts3d`: the points carry no gradient through this term
    (the pose-only term of the SPFSplat v1 loss)."""
    b, h, w, _ = pts3d.shape
    if detach_pts3d:
        pts3d = pts3d.detach()
    scale = torch.tensor([[w, w, w], [h, h, h], [1.0, 1.0, 1.0]],
                         dtype=intrinsics.dtype, device=intrinsics.device)
    pred_px = se3.project_to_cam(pts3d.reshape(b, h * w, 3), c2w,
                                 intrinsics * scale).reshape(b, h, w, 2)
    # Points near or behind the camera plane project to +-inf pixels, and
    # inf/inf in the norm's backward would poison the whole batch with NaN
    # though the hard clamp zeroes their loss: clip first (zero gradient).
    pred_px = torch.clamp(pred_px, -1e7, 1e7)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=pts3d.dtype, device=pts3d.device),
        torch.arange(w, dtype=pts3d.dtype, device=pts3d.device), indexing="ij")
    target_px = torch.stack([gx, gy], dim=-1)
    # eps inside the sqrt: a pixel with exactly zero error would otherwise
    # have a NaN gradient.
    err = torch.sqrt(torch.sum((pred_px - target_px) ** 2, dim=-1) + 1e-12)
    valid = err <= cfg.hard_clamp
    n_valid = torch.clamp(valid.sum(), min=1)
    soft = soft_clamp(global_step, cfg)
    per_px = soft * torch.tanh(err / soft)
    total = torch.sum(torch.where(valid, per_px, torch.zeros_like(per_px)))
    return cfg.weight * total / n_valid
