"""Pointmap geometry (torch port of `spfsplatv2_tpu/geometry/pointcloud.py`).

Used by the distillation loss and the DUSt3R teacher.  Batched, with
masks instead of boolean indexing, as in JAX.
"""

from __future__ import annotations

import torch


def geotrf(transform: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) rigid transform to (..., n, 3) points."""
    return (torch.einsum("...ij,...nj->...ni", transform[..., :3, :3], pts)
            + transform[..., None, :3, 3])


def depthmap_to_pts3d(depth: torch.Tensor,
                      intrinsics_px: torch.Tensor) -> torch.Tensor:
    """Z-depth map (..., h, w) + pixel-unit intrinsics -> camera points
    (..., h, w, 3), pixel centres at +0.5."""
    h, w = depth.shape[-2:]
    v, u = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device) + 0.5,
        torch.arange(w, dtype=depth.dtype, device=depth.device) + 0.5,
        indexing="ij")
    fx = intrinsics_px[..., 0, 0][..., None, None]
    fy = intrinsics_px[..., 1, 1][..., None, None]
    cx = intrinsics_px[..., 0, 2][..., None, None]
    cy = intrinsics_px[..., 1, 2][..., None, None]
    return torch.stack([depth * (u - cx) / fx, depth * (v - cy) / fy, depth],
                       dim=-1)


def normalize_pointcloud(
    pts1: torch.Tensor,
    pts2: torch.Tensor | None = None,
    norm_mode: str = "avg_dis",
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
):
    """Scale pointmaps by their mean distance to the origin over the valid
    points (the `avg_dis` mode, dense with masks).

    pts*: (b, h, w, 3); valid*: (b, h, w) bool or None.  Returns the
    normalized pts1 (and pts2 if given) and the norm factor (b,).
    """
    mode, dis_mode = norm_mode.split("_")
    if (mode, dis_mode) != ("avg", "dis"):
        raise ValueError(f"unsupported norm_mode={norm_mode!r}")

    def flat(p, valid):
        x = p.reshape(p.shape[0], -1, 3)
        m = (torch.ones(x.shape[:2], dtype=p.dtype, device=p.device)
             if valid is None else valid.reshape(p.shape[0], -1).to(p.dtype))
        return x, m

    xs, ms = flat(pts1, valid1)
    if pts2 is not None:
        x2, m2 = flat(pts2, valid2)
        xs, ms = torch.cat([xs, x2], dim=1), torch.cat([ms, m2], dim=1)
    dist = torch.linalg.norm(xs, dim=-1) * ms
    norm = dist.sum(dim=1) / (ms.sum(dim=1) + 1e-8)
    norm = torch.clamp(norm, min=1e-8)
    scale = norm.reshape((pts1.shape[0],) + (1,) * (pts1.ndim - 1))
    if pts2 is not None:
        return pts1 / scale, pts2 / scale, norm
    return pts1 / scale, norm
