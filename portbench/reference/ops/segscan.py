"""The 1-D prefix sum and the segmented scan, plain (a frozen copy of the
port's `ops/segscan.py` without its kernels K3 and K4)."""

from __future__ import annotations

import torch


def cumsum_1d_plain(vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: torch.cumsum in the input's dtype."""
    return torch.cumsum(vals, dim=0).to(vals.dtype)


def cumsum_1d(vals: torch.Tensor) -> torch.Tensor:
    return cumsum_1d_plain(vals)


def segmented_scan_lanes_plain(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4: a float64 cumulative sum along each
    row minus its value just before each element's segment start."""
    first = torch.searchsorted(seg.contiguous(), seg.contiguous())  # (n,)
    cs = torch.cumsum(vals.to(torch.float64), dim=1)
    before = torch.where(first > 0, cs[:, torch.clamp(first - 1, min=0)],
                         torch.zeros_like(cs))
    return (cs - before).to(vals.dtype)


def segmented_scan_lanes(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    return segmented_scan_lanes_plain(vals, seg)
