"""Focal estimation from predicted pointmaps by Weiszfeld IRLS (torch port
of `spfsplatv2_tpu/geometry/intrinsics.py`).

Finds the focal f that minimizes sum_i w_i |pixel_i - f (x_i, y_i) / z_i|
by iteratively reweighted least squares, with square pixels and the
principal point at the image centre.  Used when `estimating_focal` is
set.  Masks, not boolean indexing, as in JAX.
"""

from __future__ import annotations

import math

import torch


def estimate_focal_from_pointmap(pts3d: torch.Tensor, iters: int = 10,
                                 eps: float = 1e-8) -> torch.Tensor:
    """pts3d (b, h, w, 3) camera-frame points -> focal (b,) in pixels."""
    b, h, w, _ = pts3d.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=pts3d.dtype, device=pts3d.device),
        torch.arange(w, dtype=pts3d.dtype, device=pts3d.device),
        indexing="ij")
    pixels = torch.stack([xs - w / 2, ys - h / 2], -1).reshape(1, -1, 2)
    pts = pts3d.reshape(b, -1, 3)
    z = pts[..., 2]
    valid = (z > eps).to(pts3d.dtype)
    xy_over_z = torch.where((z.abs() > eps)[..., None],
                            pts[..., :2] / z[..., None],
                            torch.zeros_like(pts[..., :2]))
    dot_px = torch.sum(xy_over_z * pixels, -1) * valid
    dot_xy = torch.sum(xy_over_z**2, -1) * valid
    focal = torch.sum(dot_px, 1) / torch.clamp(torch.sum(dot_xy, 1), min=eps)
    focal_base = max(h, w) / (2 * math.tan(math.radians(30.0)))
    focal = torch.where(focal > 0, focal, torch.full_like(focal, focal_base))
    for _ in range(iters):
        resid = torch.linalg.norm(focal[:, None, None] * xy_over_z - pixels,
                                  dim=-1)
        weight = valid / torch.clamp(resid, min=eps)
        num = torch.sum(weight * dot_px, 1)
        den = torch.sum(weight * dot_xy, 1)
        focal = torch.clamp(num / torch.clamp(den, min=eps), min=eps)
    return focal


def estimate_intrinsics(pts3d: torch.Tensor) -> torch.Tensor:
    """(b, v, h, w, 3) pointmaps (view 0 is read) -> normalized K (b, 3, 3)."""
    b, _, h, w, _ = pts3d.shape
    focal_px = estimate_focal_from_pointmap(pts3d[:, 0])
    fx, fy = focal_px / w, focal_px / h
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    k = torch.stack([fx, zeros, 0.5 * ones, zeros, fy, 0.5 * ones,
                     zeros, zeros, ones], -1)
    return k.reshape(b, 3, 3)
