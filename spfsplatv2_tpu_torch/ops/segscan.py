"""Scans: the 1-D prefix sum (kernel K3) and the segmented scan (K4),
each with its plain version.

Counterpart of `spfsplatv2_tpu/ops/segscan.py`: `cumsum_1d`, whose Pallas
kernel `_cumsum_kernel` becomes the hand-written CUDA kernel in
`csrc/prefix_scan.cu`, and `segmented_scan_lanes`, whose `_segscan_kernel`
becomes `csrc/segmented_scan.cu` (the rasterizer's backward accumulation
under `SPFSPLAT_ACCUM=segscan`).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.ops import cuda_lib

SEG_TILE = 1024  # elements per CTA in csrc/segmented_scan.cu
SCAN_TILE = 8192  # elements per CTA in csrc/prefix_scan.cu
_FUNCTIONS = {torch.int32: "spf_cumsum_i32", torch.float32: "spf_cumsum_f32"}
# K3's look-back status words, one buffer per (device, stream), and the
# epoch of the last call that used it: a word written by an earlier call
# carries an older epoch and reads as unwritten.  Epochs run from 2 to
# 2^30 - 1 (the buffer is cleared when they wrap).  A CUDA graph's replays
# would repeat one epoch, so K3 is not captured.
_EPOCH_LIMIT = 1 << 30
_scan_state: dict[tuple[int, int], list] = {}


def cumsum_1d_plain(vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: torch.cumsum in the input's dtype."""
    return torch.cumsum(vals, dim=0).to(vals.dtype)


def scan_state(device: torch.device, stream: int, n: int) -> tuple:
    """K3's status words for `n` elements on this device and stream, and
    the call's epoch."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("cumsum_1d cannot be captured in a CUDA graph: "
                           "every replay would repeat its epoch")
    tiles = -(-n // SCAN_TILE)
    entry = _scan_state.get((device.index, stream))
    if entry is None or entry[0].numel() < tiles:
        entry = [torch.zeros(max(tiles, 256), dtype=torch.int64,
                             device=device), 1]
        _scan_state[device.index, stream] = entry
    entry[1] += 1
    if entry[1] == _EPOCH_LIMIT:
        entry[0].zero_()
        entry[1] = 2
    return entry[0], entry[1]


def cumsum_1d_cuda(vals: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a contiguous 1-D int32/float32 CUDA tensor."""
    if vals.dtype not in _FUNCTIONS:
        raise ValueError(f"cumsum_1d: unsupported dtype {vals.dtype}")
    device = vals.device
    cuda_lib.require(vals, "vals", vals.dtype, 1, device)
    (n,) = vals.shape
    out = torch.empty_like(vals)
    stream = cuda_lib.stream_handle(device)
    state, epoch = scan_state(device, stream, n)
    fn = getattr(cuda_lib.library("prefix_scan"), _FUNCTIONS[vals.dtype])
    err = fn(vals.data_ptr(), out.data_ptr(), state.data_ptr(), n, epoch,
             stream)
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


def segmented_scan_lanes_plain(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4: a float64 cumulative sum along each
    row minus its value just before each element's segment start."""
    first = torch.searchsorted(seg.contiguous(), seg.contiguous())  # (n,)
    cs = torch.cumsum(vals.to(torch.float64), dim=1)
    before = torch.where(first > 0, cs[:, torch.clamp(first - 1, min=0)],
                         torch.zeros_like(cs))
    return (cs - before).to(vals.dtype)


def segmented_scan_lanes_cuda(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Launch K4 on a contiguous (R, N) float32 and (N,) int32 CUDA pair."""
    cuda_lib.require(vals, "vals", torch.float32, 2, vals.device)
    cuda_lib.require(seg, "seg", torch.int32, 1, vals.device)
    rows, n = vals.shape
    if seg.shape[0] != n:
        raise ValueError(f"seg has {seg.shape[0]} ids for {n} lanes")
    out = torch.empty_like(vals)
    # The look-back's status words, one a (row, tile), and its ticket
    # counter; the kernel's C entry zeroes them on the stream, so the call
    # can be captured in a CUDA graph.
    state = torch.empty(rows * -(-n // SEG_TILE) + 1, dtype=torch.int64,
                        device=vals.device)
    fn = cuda_lib.library("segmented_scan").spf_segmented_scan
    err = fn(vals.data_ptr(), seg.data_ptr(), out.data_ptr(), state.data_ptr(),
             rows, n, cuda_lib.stream_handle(vals.device))
    cuda_lib.launch_counts["segmented_scan"] += 1
    cuda_lib.check(err, "segmented_scan")
    return out


def segmented_scan_lanes(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive sum scan along the last axis of (R, N) float32 `vals`,
    restarting wherever the non-decreasing segment ids `seg` (N,) change."""
    if vals.ndim != 2 or seg.ndim != 1:
        raise ValueError(f"segmented_scan_lanes takes (R, N) and (N,), got "
                         f"{tuple(vals.shape)} and {tuple(seg.shape)}")
    if vals.is_cuda:
        return segmented_scan_lanes_cuda(vals, seg)
    return segmented_scan_lanes_plain(vals, seg)
