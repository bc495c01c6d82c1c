"""Bilinear resize with align_corners semantics (torch port of
`spfsplatv2_tpu/utils/interp.py`).

The JAX function implements torch's `align_corners=True` sampling by hand;
here it is `F.interpolate` itself.  `resize_bilinear` keeps the JAX
function's NHWC layout; the DPT heads, which run channels-first, call
`resize_bilinear_nchw`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int],
                         align_corners: bool = True) -> torch.Tensor:
    """Resize (b, c, h, w) tensors bilinearly."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Resize (b, h, w, c) tensors bilinearly."""
    y = resize_bilinear_nchw(x.permute(0, 3, 1, 2), out_hw, align_corners)
    return y.permute(0, 2, 3, 1)
