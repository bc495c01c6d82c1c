"""Dense per-pixel reference compositor, the correctness oracle (torch port
of `spfsplatv2_tpu/ops/raster_ref.py`).

Composites ALL Gaussians against ALL pixels in exact global depth order
with the CUDA rasterizer's semantics (front to back, alpha clamp, break at
T < 1e-4).  O(pixels * gaussians): tests and small scenes only.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.ops.raster_common import (
    T_EPS,
    ProjectedGaussians,
    alpha_from_conic,
)


def composite_reference(
    proj: ProjectedGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,
):
    """Returns (color (h, w, 3), depth (h, w), alpha (h, w))."""
    h, w = image_shape
    order = torch.argsort(proj.depth, stable=True)
    xy = proj.xy[order]
    conic = proj.conic[order]
    color = proj.color[order]
    opacity = proj.opacity[order]
    depth = proj.depth[order]
    live = (proj.radius[order] > 0) & torch.isfinite(depth)

    dev, dt = xy.device, xy.dtype
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx, gy], dim=-1).reshape(-1, 2)

    alpha = alpha_from_conic(xy, conic, opacity, pix)
    alpha = torch.where(live[None, :], alpha, torch.zeros_like(alpha))

    t_incl = torch.cumprod(1.0 - alpha, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=-1)
    # CUDA break semantics: gaussian i composited iff T_{i+1} >= 1e-4.
    composited = t_incl >= T_EPS
    weight = torch.where(composited, alpha * t_excl, torch.zeros_like(alpha))
    t_final = torch.prod(
        1.0 - torch.where(composited, alpha, torch.zeros_like(alpha)), dim=-1
    )

    out_color = weight @ color + t_final[:, None] * background[None, :]
    depth_safe = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    out_depth = weight @ depth_safe
    out_alpha = 1.0 - t_final
    return (
        out_color.reshape(h, w, 3),
        out_depth.reshape(h, w),
        out_alpha.reshape(h, w),
    )
