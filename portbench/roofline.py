"""The yardstick's peaks and kernel counts (the benchmark's own copy).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): a card set below that limit runs slower under load, so
`power_limit` is printed beside every reading.  The kernel counts are
the bound formulas kept under the port's kernel table in PERF.md, from
the shapes the benchmark hands in:

  * K1 (`composite_forward_kernel`): each input Gaussian's 40-byte
    projected row read once and the (tiles, 256, 8) float32 output
    written once, at the HBM rate;
  * K2 (`composite_backward_kernel`): those rows and K1's output and its
    cotangent read once, a 40-byte gradient row a Gaussian written once;
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
TILE = 16
OUT_FIELDS = 8        # K1's output per pixel
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


def k1_bytes(gaussians: int, hw: int) -> int:
    return gaussians * ROW_BYTES + _out_bytes(hw)


def k2_bytes(gaussians: int, hw: int) -> int:
    return 2 * gaussians * ROW_BYTES + 2 * _out_bytes(hw)


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
