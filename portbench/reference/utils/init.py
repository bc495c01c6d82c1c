"""Seeded initializers with the flax initializers' rules, drawn from an
explicit `torch.Generator`."""

from __future__ import annotations

import math

import torch

# Normal quantiles of the flax truncated-normal initializer (+-2 sigma);
# 0.8796... is the std of a unit normal truncated there.
_TRUNC_STD = 0.87962566103423978
_PHI_LO, _PHI_HI = 0.022750131948179195, 0.9772498680518208


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """In place: normal(0, std) truncated at +-2 std, by inverse CDF."""
    u = torch.empty(t.shape, device=t.device, dtype=torch.float32)
    u.uniform_(_PHI_LO, _PHI_HI, generator=gen)
    with torch.no_grad():
        t.copy_(torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std))


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator,
                  scale: float = 1.0, transposed: bool = False) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal")."""
    receptive = math.prod(weight.shape[2:]) if weight.ndim > 2 else 1
    fan_in = weight.shape[0 if transposed else 1] * receptive
    trunc_normal_(weight, math.sqrt(scale / fan_in) / _TRUNC_STD, gen)
