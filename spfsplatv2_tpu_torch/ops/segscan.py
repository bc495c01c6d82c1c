"""Inclusive 1-D prefix sum: kernel K3 and its plain version.

Counterpart of `spfsplatv2_tpu/ops/segscan.py:cumsum_1d`, whose Pallas
kernel `_cumsum_kernel` becomes the hand-written CUDA kernel in
`csrc/prefix_scan.cu`.  A CPU tensor takes the plain version
(`torch.cumsum`, cast back to the input dtype); a CUDA tensor launches
the kernel or raises.  The segmented scan of the same JAX module (K4)
runs only in the backward pass and is not ported yet.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.ops import cuda_lib

BLOCK = 1024  # elements per CTA in csrc/prefix_scan.cu
_FUNCTIONS = {torch.int32: "spf_cumsum_i32", torch.float32: "spf_cumsum_f32"}


def cumsum_1d_plain(vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: torch.cumsum in the input's dtype."""
    return torch.cumsum(vals, dim=0).to(vals.dtype)


def cumsum_1d_cuda(vals: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a contiguous 1-D int32/float32 CUDA tensor."""
    if vals.dtype not in _FUNCTIONS:
        raise ValueError(f"cumsum_1d: unsupported dtype {vals.dtype}")
    cuda_lib.require(vals, "vals", vals.dtype, 1, vals.device)
    (n,) = vals.shape
    out = torch.empty_like(vals)
    totals = torch.empty((max(-(-n // BLOCK), 1),), dtype=vals.dtype,
                         device=vals.device)
    fn = getattr(cuda_lib.library("prefix_scan"), _FUNCTIONS[vals.dtype])
    err = fn(vals.data_ptr(), out.data_ptr(), totals.data_ptr(), n,
             cuda_lib.stream_handle(vals.device))
    cuda_lib.launch_counts["cumsum_1d"] += 1
    cuda_lib.check(err, "cumsum_1d")
    return out


def cumsum_1d(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of a 1-D int32 or float32 tensor."""
    if vals.ndim != 1:
        raise ValueError(f"cumsum_1d takes a 1-D tensor, got {tuple(vals.shape)}")
    if vals.is_cuda:
        return cumsum_1d_cuda(vals)
    return cumsum_1d_plain(vals)
