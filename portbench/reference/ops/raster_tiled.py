"""Tile binning and tile compositing of projected Gaussians (torch port
of `spfsplatv2_tpu/ops/raster_tiled.py`).

Prefix layout (`bin_gaussians_prefix`, `PrefixBins`; the kernel path):
every live Gaussian is expanded into one entry per 16x16 tile its
ellipse bounding box touches, keyed by (tile, depth rank); one sort of
those keys is the slot space: tile t's depth-ordered segment is
[starts[t], starts[t] + counts[t]) of the sorted live prefix.  The three
sorts are `torch.sort` (stable, so ties resolve the same way on every
run; the JAX sorts are unstable, so only the live prefix and the int
fields are comparable), the tile bounds are `torch.searchsorted`, and the
two prefix sums go through `cumsum_1d` (kernel K3 on CUDA).  Fields are
int32 at the interface and cast to int64 only to index.

The "tiled" backend (`bin_gaussians`, `composite_tiles`,
`rasterize_tiled`): Gaussians permuted into depth order, one sorted
(tile, depth rank) entry list with per-tile segment starts, and every
tile composited over a window of its front-most `max_per_tile` entries,
chunk by chunk, all tiles at once: within a chunk the front-to-back
transmittance is a cumulative product, cut where it would fall below
T_EPS, and the colour a (pixels x chunk) @ (chunk x 3) product.  Plain,
differentiable torch (no kernel): gradients reach the projected
attributes, and through them the means, covariances, opacities,
harmonics and the camera pose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.ops.raster_common import (
    T_EPS,
    ProjectedGaussians,
    alpha_from_conic,
    project_gaussians,
)
from portbench.reference.ops.segscan import cumsum_1d

TILE = 16
PIX_PER_TILE = TILE * TILE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rank_key_bits(g: int, n_tiles: int) -> int:
    """Bits of the prefix binning's key under the exact depth rank: the
    rank of g Gaussians and a tile id up to the sentinel n_tiles.  Over
    31 the binning needs `depth_key="quantized"`."""
    return max((g - 1).bit_length(), 1) + (n_tiles + 1).bit_length()


# Bits of `relative_depth_bits`: 5 of exponent (2^-31 to 1) and 23 of
# mantissa.
RELATIVE_BITS = 28


def relative_depth_bits(depth: torch.Tensor,
                        live: torch.Tensor) -> torch.Tensor:
    """Each live depth's distance behind the nearest live one, over the
    live span, clamped to [2^-31, 1], as the low RELATIVE_BITS of its
    float32 bits: (g,) int32 in [0, 2^28), monotone in depth.  The top k
    of them resolve a depth to 2^-(k - 5) of its distance behind the
    nearest; the quantized key's k bits resolve it to 2^-(k - 8) of the
    depth itself."""
    d = depth.to(torch.float32)
    nearest = torch.where(live, d, torch.inf).amin()
    offset = torch.where(live, d - nearest, torch.zeros_like(d))
    span = torch.clamp(offset.amax(), min=torch.finfo(torch.float32).tiny)
    x = torch.clamp(offset / span, min=2.0 ** -31, max=1.0)
    return x.contiguous().view(torch.int32) - ((127 - 31) << 23)


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
    key_shape: tuple[int, int] | None = None,
) -> PrefixBins:
    """Prefix-layout binning (non-differentiable); two-tier when
    `base_tiles_per_gaussian` < `max_tiles_per_gaussian`.

    `depth_key`: "rank" (the exact depth rank), "quantized" (the top
    bits of the float32 depth, as the JAX package) or "relative" (the
    top bits of `relative_depth_bits`: an orthographic view's depths lie
    within ~1e-3 of each other, one or two steps of the quantized key,
    which would composite them in index order).
    `key_shape`: the image whose tile count sets the key's split between
    tile id and depth bits (default `image_shape`).  A band of a larger
    image passes the larger image's shape, so that the quantized depth
    key keeps the same bits, and near ties the same order, as there."""
    if max_tiles_per_gaussian < 1:
        raise ValueError(f"max_tiles_per_gaussian={max_tiles_per_gaussian}")
    h, w = image_shape
    tiles_y, tiles_x = _cdiv(h, TILE), _cdiv(w, TILE)
    n_tiles = tiles_y * tiles_x
    kh, kw = key_shape or image_shape
    key_tiles = max(n_tiles, _cdiv(kh, TILE) * _cdiv(kw, TILE))

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
    tile_bits = (key_tiles + 1).bit_length()
    if depth_key == "quantized":
        row_bits = 31 - tile_bits
        rank = torch.clamp(depth_bits, min=0) >> (31 - row_bits)
    elif depth_key == "relative":
        row_bits = 31 - tile_bits
        rank = relative_depth_bits(depth, live_g) >> max(
            RELATIVE_BITS - row_bits, 0)
    elif depth_key == "rank":
        row_bits = rank_key_bits(g, key_tiles) - tile_bits
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


class TileBins(NamedTuple):
    """Depth-sorted per-tile entry lists of the "tiled" backend.

    ids_sorted: (g * max_tiles_per_gaussian,) Gaussian row per sorted
    entry, in depth-permuted row space (attribute tables are permuted by
    `order` before they are gathered by it); dead entries sort last.
    tile_starts: (n_tiles + 1,) int32 segment starts into ids_sorted.
    """

    ids_sorted: torch.Tensor
    tile_starts: torch.Tensor
    num_tiles_xy: tuple[int, int]
    order: torch.Tensor


@torch.no_grad()
def bin_gaussians(
    proj: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_tiles_per_gaussian: int,
) -> TileBins:
    """Depth-sorted per-tile entry lists (non-differentiable): each live
    Gaussian takes up to `max_tiles_per_gaussian` tiles of its radius
    box, row-major, keyed by (tile, depth rank) in one int64 sort."""
    if max_tiles_per_gaussian < 1:
        raise ValueError(f"max_tiles_per_gaussian={max_tiles_per_gaussian}")
    h, w = image_shape
    tiles_y, tiles_x = _cdiv(h, TILE), _cdiv(w, TILE)
    n_tiles = tiles_y * tiles_x
    g = proj.xy.shape[0]
    dev = proj.xy.device

    # Gaussians in depth order: the permuted row IS the depth rank.
    order = torch.argsort(proj.depth.detach(), stable=True)
    xy = proj.xy.detach()[order]
    radius = proj.radius[order]
    live = (radius > 0) & torch.isfinite(proj.depth.detach()[order])

    r = radius.to(xy.dtype)

    def tile_coord(v, lim, add=0):
        return torch.clamp(torch.floor(v / TILE) + add, 0, lim).to(torch.int64)

    x0 = tile_coord(xy[:, 0] - r, tiles_x)
    y0 = tile_coord(xy[:, 1] - r, tiles_y)
    x1 = tile_coord(xy[:, 0] + r, tiles_x, 1)
    y1 = tile_coord(xy[:, 1] + r, tiles_y, 1)
    zero = torch.zeros_like(x0)
    bw = torch.where(live, x1 - x0, zero)
    n_touched = bw * torch.where(live, y1 - y0, zero)

    d = torch.arange(max_tiles_per_gaussian, device=dev)[None, :]
    bw_safe = torch.clamp(bw, min=1)[:, None]
    slot_ok = (d < n_touched[:, None]) & live[:, None]
    tile_id = torch.where(
        slot_ok, (y0[:, None] + d // bw_safe) * tiles_x + x0[:, None]
        + d % bw_safe, torch.full_like(slot_ok, n_tiles, dtype=torch.int64))

    row_bits = max((g - 1).bit_length(), 1)
    row = torch.arange(g, device=dev)[:, None]
    key_sorted, _ = torch.sort((tile_id * (1 << row_bits) + row).reshape(-1))
    ids_sorted = (key_sorted & ((1 << row_bits) - 1)).to(torch.int32)
    bounds = torch.arange(n_tiles + 1, device=dev) * (1 << row_bits)
    tile_starts = torch.searchsorted(key_sorted, bounds).to(torch.int32)
    return TileBins(ids_sorted, tile_starts, (tiles_y, tiles_x), order)


def composite_tiles(
    proj: ProjectedGaussians,
    bins: TileBins,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    max_per_tile: int = 2048,
    chunk: int = 128,
):
    """Composite every tile over its front-most `max_per_tile` entries.
    Returns (color (h, w, 3), depth (h, w), alpha (h, w))."""
    if max_per_tile % chunk:
        raise ValueError(f"max_per_tile={max_per_tile} is no multiple of "
                         f"chunk={chunk}")
    h, w = image_shape
    tiles_y, tiles_x = bins.num_tiles_xy
    n_tiles = tiles_y * tiles_x
    dtype, dev = proj.xy.dtype, proj.xy.device
    n_gauss = proj.xy.shape[0]

    depth_safe = torch.where(torch.isfinite(proj.depth), proj.depth,
                             torch.zeros_like(proj.depth))
    packed = torch.cat([proj.xy, proj.conic, proj.color, proj.opacity[:, None],
                        depth_safe[:, None]], dim=-1)[bins.order]
    # A dummy row far off screen (alpha 0) pads every window.
    dummy = torch.zeros((1, packed.shape[-1]), dtype=dtype, device=dev)
    dummy[0, :2] = -1e9
    packed = torch.cat([packed, dummy])

    starts = bins.tile_starts[:-1].to(torch.int64)
    counts = torch.clamp(bins.tile_starts[1:] - bins.tile_starts[:-1],
                         max=max_per_tile).to(torch.int64)
    ids_padded = torch.cat([
        bins.ids_sorted.to(torch.int64),
        torch.full((max_per_tile,), n_gauss, dtype=torch.int64, device=dev)])
    k = torch.arange(max_per_tile, device=dev)
    window = torch.where(k < counts[:, None], ids_padded[starts[:, None] + k],
                         torch.full_like(k, n_gauss))       # (tiles, max)

    # Pixel centres at integer coordinates, each tile's 16 x 16 in rows.
    dyx = torch.arange(TILE, dtype=dtype, device=dev)
    py, px = torch.meshgrid(dyx, dyx, indexing="ij")
    local = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)  # (P, 2)
    tile = torch.arange(n_tiles, device=dev)
    origin = torch.stack([tile % tiles_x, tile // tiles_x], dim=-1).to(dtype)
    pix = local[None] + TILE * origin[:, None]              # (tiles, P, 2)

    t_carry = torch.ones((n_tiles, PIX_PER_TILE), dtype=dtype, device=dev)
    color = torch.zeros((n_tiles, PIX_PER_TILE, 3), dtype=dtype, device=dev)
    depth = torch.zeros((n_tiles, PIX_PER_TILE), dtype=dtype, device=dev)
    # Chunks past every tile's window hold only the dummy row and change
    # nothing: the loop stops at the deepest window.
    for c0 in range(0, _cdiv(int(counts.max()), chunk) * chunk, chunk):
        attrs = packed[window[:, c0:c0 + chunk]]            # (tiles, C, 10)
        alpha = alpha_from_conic(attrs[..., 0:2], attrs[..., 2:5],
                                 attrs[..., 8], pix)        # (tiles, P, C)
        om = 1.0 - alpha
        cp = torch.cumprod(om, dim=-1)
        composited = (t_carry[..., None] * cp).detach() >= T_EPS
        cp_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], -1)
        weight = torch.where(composited, alpha * t_carry[..., None] * cp_excl,
                             torch.zeros_like(alpha))
        color = color + weight @ attrs[..., 5:8]
        depth = depth + (weight @ attrs[..., 9:10])[..., 0]
        t_carry = t_carry * torch.prod(
            torch.where(composited, om, torch.ones_like(om)), dim=-1)
    color = color + t_carry[..., None] * background

    def untile(x):
        x = x.reshape(tiles_y, tiles_x, TILE, TILE, -1)
        x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, -1)
        return x[:h, :w]

    return untile(color), untile(depth)[..., 0], untile(1.0 - t_carry)[..., 0]


def rasterize_tiled(
    means, covariances, harmonics, opacities, c2w, intrinsics, background,
    image_shape: tuple[int, int],
    sh_degree: int | None = None,
    use_sh: bool = True,
    max_tiles_per_gaussian: int = 16,
    max_per_tile: int = 2048,
    chunk: int = 128,
):
    """Single-camera tiled rasterization: project, bin, composite."""
    proj = project_gaussians(
        means, covariances, harmonics, opacities, c2w, intrinsics,
        image_shape, sh_degree=sh_degree, use_sh=use_sh,
    )
    bins = bin_gaussians(proj, image_shape, max_tiles_per_gaussian)
    return composite_tiles(proj, bins, image_shape, background,
                           max_per_tile=max_per_tile, chunk=chunk)
