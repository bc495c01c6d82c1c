"""Camera-aware pixel embeddings: SH-of-ray, sinusoidal and Plucker (torch
port of `spfsplatv2_tpu/geometry/camera_emb.py`).

For backbones that embed the intrinsics pixelwise; no preset uses them.
"""

from __future__ import annotations

import math

import torch

from spfsplatv2_tpu_torch.geometry.projection import (
    get_world_rays,
    sample_image_grid,
    unproject,
)
from spfsplatv2_tpu_torch.ops.sh import sh_basis


def _camera_plane(intrinsics: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(..., 3, 3) normalized intrinsics -> camera rays at z = 1,
    (..., h, w, 3)."""
    coords, _ = sample_image_grid(hw, intrinsics.dtype, intrinsics.device)
    return unproject(coords, torch.ones_like(coords[..., 0]),
                     intrinsics[..., None, None, :, :])


def get_intrinsic_embedding(intrinsics: torch.Tensor, hw: tuple[int, int],
                            degree: int = 0) -> torch.Tensor:
    """Pixelwise SH of the unit ray direction, (..., h, w, (degree+1)^2),
    or the direction itself (..., h, w, 3) at degree 0."""
    dirs = _camera_plane(intrinsics, hw)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs if degree == 0 else sh_basis(dirs, degree)


def get_intrinsic_positional_embedding(intrinsics: torch.Tensor,
                                       hw: tuple[int, int],
                                       d_model: int) -> torch.Tensor:
    """Sinusoidal embedding of the camera-plane (x, y) ray coordinates,
    (..., h, w, d_model): sin x, cos x, sin y, cos y interleaved."""
    xy = _camera_plane(intrinsics, hw)[..., :2]
    half = d_model // 2
    div = torch.exp(torch.arange(0, half, 2, dtype=torch.float32,
                                 device=xy.device) * (-math.log(10000.0) / half))
    x, y = xy[..., 0:1] * div, xy[..., 1:2] * div
    pe = torch.zeros((*xy.shape[:-1], d_model), dtype=xy.dtype, device=xy.device)
    pe[..., 0::4] = torch.sin(x)
    pe[..., 1::4] = torch.cos(x)
    pe[..., 2::4] = torch.sin(y)
    pe[..., 3::4] = torch.cos(y)
    return pe


def get_plucker_embedding(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                          hw: tuple[int, int]) -> torch.Tensor:
    """Plucker ray embedding (..., h, w, 6) = [o x d | d]."""
    coords, _ = sample_image_grid(hw, intrinsics.dtype, intrinsics.device)
    origins, dirs = get_world_rays(coords, extrinsics[..., None, None, :, :],
                                   intrinsics[..., None, None, :, :])
    return torch.cat([torch.linalg.cross(origins, dirs, dim=-1), dirs], dim=-1)
