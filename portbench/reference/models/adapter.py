"""Gaussian adapters: raw head channels -> world-space Gaussians.

Torch port of `spfsplatv2_tpu/models/adapter.py` (the pose-free unified
adapter and the density -> opacity warm-up mapping).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.gaussians import Gaussians
from portbench.reference.ops.covariance import build_covariance


def sh_mask(sh_degree: int) -> np.ndarray:
    """Per-degree damping mask 0.1 * 0.25**degree biasing toward DC."""
    d_sh = (sh_degree + 1) ** 2
    mask = np.ones((d_sh,), np.float32)
    for degree in range(1, sh_degree + 1):
        mask[degree**2: (degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def map_pdf_to_opacity(
    pdf: torch.Tensor, global_step, initial: float = 0.0, final: float = 0.0,
    warm_up: int = 1,
) -> torch.Tensor:
    """Density -> opacity with an exponent warm-up schedule."""
    x = initial + min(global_step / warm_up, 1.0) * (final - initial)
    exponent = 2.0**x
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


def unified_gaussian_adapter(
    means: torch.Tensor,          # (..., 3) world-space pointmap
    opacities: torch.Tensor,      # (...,)
    raw_gaussians: torch.Tensor,  # (..., 7 + 3 * d_sh)
    sh_degree: int = 4,
    eps: float = 1e-8,
) -> Gaussians:
    d_sh = (sh_degree + 1) ** 2
    scales = raw_gaussians[..., 0:3]
    rotations = raw_gaussians[..., 3:7]
    sh = raw_gaussians[..., 7: 7 + 3 * d_sh]

    scales = torch.clamp(0.001 * F.softplus(scales), max=0.3)
    rotations = rotations / (
        torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps
    )
    mask = torch.as_tensor(sh_mask(sh_degree), device=sh.device)
    sh = sh.reshape(*sh.shape[:-1], 3, d_sh) * mask
    covariances = build_covariance(scales, rotations)
    return Gaussians(
        means=means,
        covariances=covariances,
        scales=scales,
        rotations=rotations,
        harmonics=sh,
        opacities=opacities,
    )


def raw_gaussian_channels(sh_degree: int = 4) -> int:
    """1 (opacity) + 3 (scale) + 4 (rotation) + 3 * d_sh (SH)."""
    return 1 + 7 + 3 * (sh_degree + 1) ** 2
