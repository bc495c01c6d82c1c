"""The yardstick's peaks and kernel counts (the benchmark's own copy).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): a card set below that limit runs slower under load, so
`power_limit` is printed beside every reading.  The kernel counts are
the bound formulas kept under the port's kernel table in PERF.md, from
the shapes and counts the benchmark hands in:

  * K1 (`composite_forward_kernel`): the work a launch must do on the
    data it is given (`raster_work.py`), as the larger of two times:
    bytes (each distinct 40-byte projected row that some tile's
    front-to-back walk reaches read once, a 4-byte index for each tile
    entry walked, and the (tiles, 256, 8) float32 output written once,
    at the HBM rate) and operations (`K1_PAIR_OPS` for each pixel-entry
    pair the walk blends, at the FP32 rate).  A lower bound on both: no
    sound kernel reads over 100% of it;
  * K2 (`composite_backward_kernel`): bytes, those rows and indices, K1's
    output and its cotangent read once and a 40-byte gradient row
    written for each row reached; operations, `K2_PAIR_OPS` a blended
    pair;
  * K5's forward (`flash_forward_kernel`): 4 b h n_q n_k d operations at
    the bf16 tensor-core rate, for every unmasked self-attention of the
    flagship's backbone with at least `FLASH_MIN_KV` keys.
"""

from __future__ import annotations

import math
import subprocess

PEAK_BF16 = 989e12   # FLOP/s, bf16 and fp16 tensor cores
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12    # outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
ROW_BYTES = 40        # K1/K2's packed row: 10 float32 fields
ENTRY_BYTES = 4       # a tile entry: the int32 row index
TILE = 16
OUT_FIELDS = 8        # K1's output per pixel
# FP32 operations of a blended (pixel, entry) pair, as the kernel table
# counts them (`chip_smoke.py`: K1 14 to evaluate the pair and 11 to
# blend it; K2 the same 14 and 51 for the gradient and its sums).
K1_PAIR_OPS = 14 + 11
K2_PAIR_OPS = 14 + 51
FLASH_MIN_KV = 4096   # keys at which the port's self-attention takes K5

KERNELS = {"k1": "composite_forward_kernel",
           "k2": "composite_backward_kernel",
           "k5_fwd": "flash_forward_kernel"}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"unread ({err.__class__.__name__})"
    return out.splitlines()[0] if out else "unread"


def _out_bytes(hw: int) -> int:
    tiles = math.ceil(hw / TILE) ** 2
    return tiles * TILE * TILE * OUT_FIELDS * 4


def k1_bytes(rows: int, entries: int, hw: int) -> int:
    """One K1 launch: `rows` distinct rows reached, `entries` walked."""
    return rows * ROW_BYTES + entries * ENTRY_BYTES + _out_bytes(hw)


def k2_bytes(rows: int, entries: int, hw: int) -> int:
    """One K2 launch over the same walk: rows in and gradient rows out,
    the indices, K1's output and its cotangent."""
    return 2 * rows * ROW_BYTES + entries * ENTRY_BYTES + 2 * _out_bytes(hw)


RASTER = {"k1": (k1_bytes, K1_PAIR_OPS), "k2": (k2_bytes, K2_PAIR_OPS)}


def raster_least_s(kernel: str, rows: int, entries: int, pairs: int,
                   hw: int) -> float:
    """The least time of one `kernel` ("k1" or "k2") launch whose walk
    reaches `rows` distinct rows over `entries` tile entries and blends
    `pairs` pixel-entry pairs: the larger of its bytes at the HBM rate
    and its operations at the FP32 rate."""
    bytes_of, pair_ops = RASTER[kernel]
    return max(bytes_of(rows, entries, hw) / PEAK_BYTES,
               pairs * pair_ops / PEAK_FP32)


def raster_share(r, kernel: str) -> float | None:
    """The share of its roofline, in %, of `kernel` ("k1" or "k2") over
    the traced segment: the least time of its launches, from the walk
    counted on each item's own Gaussians and cameras (`Readings.raster`,
    (rows, entries, pairs) a launch), over their device time.  Nothing
    where there is no trace or count, or where the segment's launches
    are not the ones counted."""
    if r.trace is None or not r.raster:
        return None
    seconds, n = r.trace.time_by_name(KERNELS[kernel])
    if n != len(r.raster) or seconds <= 0:
        return None
    hw = r.traffic["image_size"]
    least = sum(raster_least_s(kernel, *work, hw) for work in r.raster)
    return 100.0 * least / seconds


def k5_forward_shapes(config: dict, traffic: dict) -> list[tuple]:
    """(b, h, n_q, n_k, d) of each K5 forward launch of one serving
    request of the CroCo backbone: every per-view self-attention with
    FLASH_MIN_KV keys or more (encoder blocks over all views; the first
    decoder over view 0, the second over the others).  Empty for a
    configuration without a CroCo backbone."""
    bb = config["encoder"].get("backbone")
    if bb is None:
        return []
    views = len(traffic["context_offsets"]) + len(traffic["target_offsets"])
    p = (traffic["image_size"] // bb["patch_size"]) ** 2
    extra = int(bb["intrinsics_token"]) + int(bb["pose_token"])
    enc = (views, bb["enc_num_heads"], p, p,
           bb["enc_embed_dim"] // bb["enc_num_heads"])
    d_dec = bb["dec_embed_dim"] // bb["dec_num_heads"]
    n = p + extra
    shapes = [enc] * bb["enc_depth"]
    shapes += [(1, bb["dec_num_heads"], n, n, d_dec)] * bb["dec_depth"]
    shapes += [(views - 1, bb["dec_num_heads"], n, n, d_dec)] * bb["dec_depth"]
    return [s for s in shapes if s[3] >= FLASH_MIN_KV]


def k5_forward_flops(shapes) -> float:
    return sum(4.0 * b * h * nq * nk * d for b, h, nq, nk, d in shapes)
