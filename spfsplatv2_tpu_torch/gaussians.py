"""Gaussian container (torch port of `spfsplatv2_tpu/gaussians.py`).

A flat batch of 3D Gaussians: world-space means, covariances, raw
scale/rotation, SH colour coefficients and opacities, with `*batch`
leading dims (typically `(b, g)`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch


@dataclass
class Gaussians:
    means: torch.Tensor        # (*batch, 3)
    covariances: torch.Tensor  # (*batch, 3, 3)
    scales: torch.Tensor       # (*batch, 3)
    rotations: torch.Tensor    # (*batch, 4) unit wxyz quaternions
    harmonics: torch.Tensor    # (*batch, 3, d_sh)
    opacities: torch.Tensor    # (*batch,)

    @property
    def d_sh(self) -> int:
        return self.harmonics.shape[-1]

    @property
    def sh_degree(self) -> int:
        return math.isqrt(self.d_sh) - 1

    def flatten_views(self) -> "Gaussians":
        """Merge a (b, v, r, ...) layout into (b, v*r, ...)."""
        def merge(x, trailing):
            lead = x.shape[: x.ndim - trailing]
            tail = x.shape[x.ndim - trailing:]
            return x.reshape(lead[0], -1, *tail)

        return Gaussians(
            means=merge(self.means, 1),
            covariances=merge(self.covariances, 2),
            scales=merge(self.scales, 1),
            rotations=merge(self.rotations, 1),
            harmonics=merge(self.harmonics, 2),
            opacities=merge(self.opacities, 0),
        )

    def map(self, fn) -> "Gaussians":
        """Apply `fn` to every field (e.g. select one scene of a batch)."""
        return Gaussians(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})
