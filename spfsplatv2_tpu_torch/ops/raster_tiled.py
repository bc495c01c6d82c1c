"""Prefix-layout tile binning of projected Gaussians (torch port).

Counterpart of `spfsplatv2_tpu/ops/raster_tiled.py:bin_gaussians_prefix`
and `PrefixBins`.  Every live Gaussian is expanded into one entry per
16x16 tile its ellipse bounding box touches, keyed by (tile, depth rank);
one sort of those keys is the slot space: tile t's depth-ordered segment
is [starts[t], starts[t] + counts[t]) of the sorted live prefix.

The three sorts are `torch.sort` (stable, so ties resolve the same way on
every run; the JAX sorts are unstable, so only the live prefix and the
int fields are comparable), the tile bounds are `torch.searchsorted`, and
the two prefix sums go through `cumsum_1d` (kernel K3 on CUDA).  Fields
are int32 at the interface and cast to int64 only to index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spfsplatv2_tpu_torch.ops.raster_common import ProjectedGaussians
from spfsplatv2_tpu_torch.ops.segscan import cumsum_1d

TILE = 16
PIX_PER_TILE = TILE * TILE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PrefixBins(NamedTuple):
    """Prefix entry layout; see `spfsplatv2_tpu/ops/raster_tiled.py`.

    flat:  (e_pad,) int32 expansion slot per sorted slot (unique).
    src:   (e_pad,) int32 Gaussian row feeding each slot.
    counts, starts: (n_tiles,) int32 segment of each tile.
    n_live: () int32 live slots kept; n_overflow: () int32 live entries
    dropped by the budget or by pool exhaustion.
    src_order/src_sorted: (e_pad,) source-order permutation of the slots.
    live_counts/ends: (g,) kept entries per Gaussian and their cumsum.
    has_drops: () bool, whether the budget dropped live entries.
    """

    flat: torch.Tensor
    src: torch.Tensor
    counts: torch.Tensor
    starts: torch.Tensor
    n_live: torch.Tensor
    num_tiles_xy: tuple[int, int]
    e_pad: int
    dup: int
    n_overflow: torch.Tensor
    base_dup: int
    src_order: torch.Tensor
    src_sorted: torch.Tensor
    live_counts: torch.Tensor
    ends: torch.Tensor
    has_drops: torch.Tensor


@torch.no_grad()
def bin_gaussians_prefix(
    proj: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_tiles_per_gaussian: int,
    chunk: int,
    entry_budget: int,
    base_tiles_per_gaussian: int | None = None,
    big_pool_factor: float = 0.125,
    depth_key: str = "rank",
) -> PrefixBins:
    """Prefix-layout binning (non-differentiable); two-tier when
    `base_tiles_per_gaussian` < `max_tiles_per_gaussian`."""
    if max_tiles_per_gaussian < 1:
        raise ValueError(f"max_tiles_per_gaussian={max_tiles_per_gaussian}")
    h, w = image_shape
    tiles_y, tiles_x = _cdiv(h, TILE), _cdiv(w, TILE)
    n_tiles = tiles_y * tiles_x

    xy = proj.xy.detach()
    depth = proj.depth.detach()
    radius = proj.radius
    dev = xy.device
    g = xy.shape[0]
    dup = max_tiles_per_gaussian
    dup_a = base_tiles_per_gaussian
    if dup_a is None or dup_a >= dup:
        dup_a = dup
    extra = dup - dup_a

    live_g = (radius > 0) & torch.isfinite(depth)

    depth_bits = depth.to(torch.float32).contiguous().view(torch.int32)
    row_bits_needed = max((g - 1).bit_length(), 1)
    tile_bits = (n_tiles + 1).bit_length()
    if depth_key == "quantized":
        row_bits = 31 - tile_bits
        rank = torch.clamp(depth_bits, min=0) >> (31 - row_bits)
    elif depth_key == "rank":
        row_bits = row_bits_needed
        order = torch.argsort(depth_bits, stable=True)
        rank = torch.argsort(order, stable=True).to(torch.int32)
    else:
        raise ValueError(f"bad depth_key {depth_key!r}")
    if row_bits + tile_bits > 31:
        raise ValueError(
            f"prefix binning key overflows int32 for g={g}, "
            f"n_tiles={n_tiles}; use depth_key='quantized'"
        )

    rx = proj.rx.to(xy.dtype)
    ry = proj.ry.to(xy.dtype)

    def tile_coord(v, lim, add=0):
        return torch.clamp(torch.floor(v / TILE) + add, 0, lim).to(torch.int32)

    x0 = tile_coord(xy[:, 0] - rx, tiles_x)
    y0 = tile_coord(xy[:, 1] - ry, tiles_y)
    x1 = tile_coord(xy[:, 0] + rx, tiles_x, 1)
    y1 = tile_coord(xy[:, 1] + ry, tiles_y, 1)
    zero = torch.zeros_like(x0)
    bw = torch.where(live_g, x1 - x0, zero)
    bh = torch.where(live_g, y1 - y0, zero)
    n_touched = bw * bh

    sentinel_key = n_tiles << row_bits
    bw_safe = torch.clamp(bw, min=1)
    shift = 1 << row_bits

    def tier_keys(rows_sel, d_lo, d_hi, row_live):
        """(tile << row_bits | rank) keys for slots d in [d_lo, d_hi), by
        the incremental bounding-box walk of the JAX function."""
        sel = (lambda a: a[rows_sel]) if rows_sel is not None else (lambda a: a)
        bws = sel(bw_safe)
        nt = sel(n_touched)
        rk = sel(rank)
        sentinel = torch.full_like(rk, sentinel_key)
        cols = []
        dx = torch.zeros_like(bws)
        tid = sel(y0) * tiles_x + sel(x0)
        for d in range(d_hi):
            if d >= d_lo:
                ok = (d < nt) & row_live
                cols.append(torch.where(ok, tid * shift + rk, sentinel))
            nx = dx + 1
            wrap = nx >= bws
            dx = torch.where(wrap, torch.zeros_like(nx), nx)
            tid = torch.where(wrap, tid + (tiles_x - bws + 1), tid + 1)
        return torch.stack(cols, dim=1)

    key_a = tier_keys(None, 0, dup_a, live_g)             # (g, dup_a)
    flat_a = torch.arange(g * dup_a, dtype=torch.int32, device=dev)

    in_pool = None
    if extra > 0:
        # Compact the "big" rows (more than dup_a tiles) to a static pool,
        # lowest row ids first.
        pool = min(g, max(64, int(g * big_pool_factor)))
        big = (n_touched > dup_a) & live_g
        rows = torch.arange(g, dtype=torch.int32, device=dev)
        bigkey = torch.where(big, torch.zeros_like(rows),
                             torch.full_like(rows, 1 << 30)) | rows
        big_sorted, _ = torch.sort(bigkey, stable=True)
        pool_rows = big_sorted[:pool] & ((1 << 30) - 1)     # (B,)
        pool_idx = pool_rows.long()
        in_pool = big & (cumsum_1d(big.to(torch.int32)) - 1 < pool)
        key_b = tier_keys(pool_idx, dup_a, dup, big[pool_idx])  # (B, extra)
        d2 = torch.arange(extra, dtype=torch.int32, device=dev)[None, :]
        flat_b = g * dup_a + pool_rows[:, None] * extra + d2
        key = torch.cat([key_a.reshape(-1), key_b.reshape(-1)])
        flat_all = torch.cat([flat_a, flat_b.reshape(-1)])
    else:
        key = key_a.reshape(-1)
        flat_all = flat_a
    total_slots = key.shape[0]

    key_sorted, perm = torch.sort(key, stable=True)
    flat_sorted = flat_all[perm]
    bound = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev) * shift
    tile_starts = torch.searchsorted(key_sorted, bound).to(torch.int32)

    budget = min(entry_budget, total_slots)
    e_pad = _cdiv(budget, chunk) * chunk + chunk
    starts = tile_starts[:-1]
    diff = tile_starts[1:] - tile_starts[:-1]
    counts = torch.clamp(torch.minimum(diff, budget - starts), min=0)
    n_live = torch.clamp(tile_starts[-1], max=budget)
    capped_touch = torch.sum(
        torch.where(live_g, torch.clamp(n_touched, max=dup), zero)
    ).to(torch.int32)
    n_overflow = (
        torch.clamp(tile_starts[-1] - budget, min=0)
        + (capped_touch - tile_starts[-1])
    )

    if e_pad <= total_slots:
        flat_p = flat_sorted[:e_pad]
    else:
        # Out-of-range flat ids pad the tail (never a real slot).
        flat_p = torch.cat([
            flat_sorted,
            g * dup + torch.arange(e_pad - total_slots, dtype=torch.int32,
                                   device=dev),
        ])
    if extra > 0:
        src = torch.where(
            flat_p < g * dup_a,
            torch.div(flat_p, dup_a, rounding_mode="floor"),
            torch.div(flat_p - g * dup_a, extra, rounding_mode="floor"),
        )
    else:
        src = torch.div(flat_p, dup_a, rounding_mode="floor")
    pos = torch.arange(e_pad, dtype=torch.int32, device=dev)
    g_t = torch.tensor(g, dtype=torch.int32, device=dev)
    src_stream = torch.where(pos < n_live, torch.minimum(src, g_t), g_t)
    src_sorted, src_order = torch.sort(src_stream, stable=True)
    src_order = src_order.to(torch.int32)

    cap_a = torch.clamp(n_touched, max=dup_a)
    if extra > 0:
        tier_b = torch.where(
            in_pool, torch.clamp(n_touched - dup_a, 0, extra), zero
        )
        live_counts = torch.where(live_g, cap_a + tier_b, zero)
    else:
        live_counts = torch.where(live_g, cap_a, zero)
    live_counts = live_counts.to(torch.int32)
    ends = cumsum_1d(live_counts)
    has_drops = tile_starts[-1] > budget
    return PrefixBins(
        flat_p, src.to(torch.int32), counts.to(torch.int32), starts,
        n_live.to(torch.int32), (tiles_y, tiles_x), e_pad, dup,
        n_overflow.to(torch.int32), dup_a, src_order, src_sorted,
        live_counts, ends, has_drops,
    )
