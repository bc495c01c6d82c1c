"""Pointmap head postprocessing (torch port of
`spfsplatv2_tpu/models/heads/postprocess.py`): the "exp"
parameterization splits the raw output into a unit direction and a
distance through expm1, with the JAX package's distance cap."""

from __future__ import annotations

import torch

D_CAP = 9.21


def pts3d_postprocess(raw_xyz: torch.Tensor, mode: str = "exp") -> torch.Tensor:
    """(..., 3) raw head output -> (..., 3) 3D points."""
    if mode == "linear":
        return raw_xyz
    d = torch.sqrt(torch.sum(raw_xyz**2, dim=-1, keepdim=True) + 1e-16)
    direction = raw_xyz / torch.clamp(d, min=1e-8)
    if mode == "exp":
        d = torch.where(
            d <= D_CAP, d,
            D_CAP + 0.1 * torch.log1p(torch.clamp(d - D_CAP, min=0.0)),
        )
        return direction * torch.expm1(d)
    if mode == "square":
        return direction * d**2
    raise ValueError(f"bad pts3d mode {mode!r}")
