"""Running one call with cuDNN off.

cuDNN 9.2 picks an FFT algorithm for some of the DPT heads' float32
convolutions (TF32 off) once they get 2 or more maps: hundreds of ms and
tens of GB of workspace where PyTorch's own im2col + GEMM takes a few ms
("conv_probe" in chip_smoke.py).  The heads run the forward of each such
convolution through `without_cudnn` (models/heads/dpt.py,
models/vggt/dpt_head.py).
"""

from __future__ import annotations

import torch


def without_cudnn(fn, *args):
    """fn(*args) with cuDNN off (only `enabled` is touched: cuDNN's
    `flags()` would also reset its TF32 and precision settings)."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.enabled = enabled
