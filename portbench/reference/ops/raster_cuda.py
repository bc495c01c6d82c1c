"""Per-tile compositing over the prefix layout, plain: a frozen copy of
the port's `ops/raster_cuda.py` with the plain versions of its kernels K1
and K2 on every device (rows summed per Gaussian by `index_add_`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.ops.raster_common import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    ProjectedGaussians,
)
from portbench.reference.ops.raster_tiled import PIX_PER_TILE, TILE, PrefixBins
from portbench.reference.ops.segscan import segmented_scan_lanes

NUM_FIELDS = 10  # [mx, my, conic a, b, c, r, g, b, opacity, depth]
OUT_FIELDS = 8   # [r, g, b, depth, 1 - T, T, 0, 0]
# Backward accumulation, the JAX package's switch (raster_pallas.py:733):
# "segsum" (the default) or "segscan".
ACCUM_MODE = "segsum"


class _Chunk(NamedTuple):
    """One chunk of every tile's segment in the plain versions' walk;
    (t, k) per tile and entry, (t, p, k) per tile, pixel and entry."""

    valid: torch.Tensor       # (t, k) entry inside the tile's segment
    slot: torch.Tensor        # (t, k) slot index
    rows: torch.Tensor        # (t, k, 10) packed rows
    dx: torch.Tensor          # (t, p, k) pixel minus mean
    dy: torch.Tensor
    alpha: torch.Tensor       # (t, p, k) zero where skipped
    t_excl: torch.Tensor      # (t, p, k) T before the entry
    composited: torch.Tensor  # (t, p, k)
    w: torch.Tensor           # (t, p, k) blend weight
    done: torch.Tensor        # (t, p) stopped before this chunk
    stopped: torch.Tensor     # (t, p) stopped in this chunk
    t_carry: torch.Tensor     # (t, p) T after this chunk


# The cull box's constants (csrc/composite_common.cuh, which derives them).
CULL_OP_MIN = 0.999 * ALPHA_MIN  # skipped at every pixel below this
CULL_DET_MIN = 1e-4            # cull a conic only if det > this x a c
CULL_AC_MIN = 1e-30            # ... and a c >= this
CULL_QUAD_MAX = 1e36           # ... and max(a, c) (max |m| + 16)^2 < this
CULL_T_REL, CULL_T_ABS = 1.0 + 1.0 / 64, 1.0 / 65536
CULL_EXT_REL, CULL_EXT_ABS = 1.0 + 1.0 / 128, 1.0 / 1024


def cull_box_plain(mx, my, a, b, c, op):
    """The kernels' cull box of each entry, in the tile's pixel grid.

    Takes float32 (n,) tensors: the tile-local mean (mean minus the tile's
    origin), the conic and the opacity.  Returns inclusive int64 pixel
    bounds (x_lo, x_hi, y_lo, y_hi) within [0, 15]: outside them the
    kernels' `entry_alpha` skips the entry (x_lo > x_hi or y_lo > y_hi: at
    every pixel of the tile).  A pixel keeps an entry only where q = a dx^2
    + 2 b dx dy + c dy^2 <= t = 2 ln(255 op), whose box has half-extents
    sqrt(t c / det) and sqrt(t a / det); t and the extents are inflated
    for float32 rounding.  Entries whose conic the cull cannot trust (not
    finite, not positive definite, ill-conditioned, or large enough for
    the power to overflow) keep the whole tile; one with op < 0.999 / 255
    none (just under 1/255, expf's rounding may keep it where power ~ 0).
    The same float32 operations as `cull_box` in the CUDA header.
    """
    ac = a * c
    det = ac - b * b
    r = torch.maximum(mx.abs(), my.abs()) + 16.0
    finite = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(b)
              & torch.isfinite(op) & torch.isfinite(ac) & torch.isfinite(det))
    trusted = (finite & (a > 0) & (c > 0) & (ac >= CULL_AC_MIN)
               & (det > CULL_DET_MIN * ac)
               & (torch.maximum(a, c) * r * r < CULL_QUAD_MAX))
    t = (torch.clamp(2.0 * torch.log(255.0 * op), min=0.0) * CULL_T_REL
         + CULL_T_ABS)

    def axis(m, num):
        ext = torch.sqrt(t * num / det) * CULL_EXT_REL + CULL_EXT_ABS
        lo = torch.clamp(m - ext, -1.0, 16.0).ceil().long().clamp(min=0)
        hi = torch.clamp(m + ext, -1.0, 16.0).floor().long().clamp(max=15)
        return lo, hi

    (x_lo, x_hi), (y_lo, y_hi) = axis(mx, c), axis(my, a)
    empty = (op < CULL_OP_MIN) | (x_lo > x_hi) | (y_lo > y_hi)
    whole = torch.stack([torch.zeros_like(x_lo), torch.full_like(x_lo, 15)])
    x_lo, x_hi, y_lo, y_hi = (
        torch.where(trusted, torch.where(empty, e, v), w)
        for v, e, w in zip((x_lo, x_hi, y_lo, y_hi), (16, -1, 16, -1),
                           (whole[0], whole[1], whole[0], whole[1])))
    return x_lo, x_hi, y_lo, y_hi


def _plain_walk(packed, src, counts, starts, tiles_x, chunk):
    """The plain versions' front-to-back walk, batched over tiles.

    Each step gathers entries [c0, c0 + chunk) of every tile's segment
    (masked past its count) and applies the CUDA break rule (a pixel stops
    for good at its first entry with T * (1 - alpha) < 1e-4) with a
    cumulative product along the chunk and a `done` mask.  Yields one
    `_Chunk` per step, until every pixel has stopped.
    """
    dev = packed.device
    n_tiles = counts.shape[0]
    g = packed.shape[0]
    pix = torch.arange(PIX_PER_TILE, device=dev)
    px = (pix % TILE).to(torch.float32)
    py = (pix // TILE).to(torch.float32)
    tile = torch.arange(n_tiles, device=dev)
    ox = ((tile % tiles_x) * TILE).to(torch.float32)
    oy = ((tile // tiles_x) * TILE).to(torch.float32)
    t_carry = torch.ones((n_tiles, PIX_PER_TILE), device=dev)
    done = torch.zeros((n_tiles, PIX_PER_TILE), dtype=torch.bool, device=dev)
    counts64 = counts.long()
    max_count = int(counts64.max()) if n_tiles else 0
    step = torch.arange(chunk, device=dev)
    for c0 in range(0, max_count, chunk):
        idx = c0 + step
        valid = idx[None, :] < counts64[:, None]                 # (t, k)
        slot = torch.clamp(starts.long()[:, None] + idx[None, :],
                           max=src.shape[0] - 1)
        rows = packed[torch.clamp(src[slot].long(), 0, g - 1)]   # (t, k, 10)
        dx = px[None, :, None] - (rows[..., 0] - ox[:, None])[:, None, :]
        dy = py[None, :, None] - (rows[..., 1] - oy[:, None])[:, None, :]
        ca = rows[..., 2][:, None, :]
        cb = rows[..., 3][:, None, :]
        cc = rows[..., 4][:, None, :]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(rows[..., 8][:, None, :] * torch.exp(power),
                            max=ALPHA_MAX)
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[:, None, :]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        t_incl = t_carry[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
        live = (~done)[..., None] & valid[:, None, :]
        composited = (t_incl >= T_EPS) & live
        t_excl = torch.cat([t_carry[..., None], t_incl[..., :-1]], dim=-1)
        w = torch.where(composited, alpha * t_excl, torch.zeros_like(alpha))
        stopped = ((t_incl < T_EPS) & live).any(dim=-1)
        t_carry = torch.where(composited, t_incl, t_carry[..., None]).amin(dim=-1)
        yield _Chunk(valid, slot, rows, dx, dy, alpha, t_excl, composited, w,
                     done, stopped, t_carry)
        done = done | stopped
        if bool(done.all()):
            break


def composite_forward_plain_work(
    packed: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
    starts: torch.Tensor, tiles_x: int, chunk: int = 128,
) -> tuple[torch.Tensor, int, int]:
    """The plain version, plus the (pixel, entry) pairs this data needs.

    Returns the (n_tiles, 256, 8) output of `_plain_walk`, the pairs
    walked (every entry of a pixel up to and including the one that
    stopped it) and the pairs blended (composited with a non-zero weight).
    """
    dev = packed.device
    n_tiles = counts.shape[0]
    t_carry = torch.ones((n_tiles, PIX_PER_TILE), device=dev)
    color = torch.zeros((n_tiles, PIX_PER_TILE, 3), device=dev)
    depth = torch.zeros((n_tiles, PIX_PER_TILE), device=dev)
    visits = torch.zeros((n_tiles, PIX_PER_TILE), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
    for ch in _plain_walk(packed, src, counts, starts, tiles_x, chunk):
        color += torch.einsum("tpk,tkc->tpc", ch.w, ch.rows[..., 5:8])
        depth += torch.einsum("tpk,tk->tp", ch.w, ch.rows[..., 9])
        n_valid = ch.valid.sum(dim=-1)[:, None].expand_as(visits)
        walked = torch.where(ch.stopped, ch.composited.sum(dim=-1) + 1, n_valid)
        visits += torch.where(ch.done, torch.zeros_like(walked), walked)
        blended += (ch.w > 0).sum()
        t_carry = ch.t_carry
    out = torch.zeros((n_tiles, PIX_PER_TILE, OUT_FIELDS), device=dev)
    out[..., 0:3] = color
    out[..., 3] = depth
    out[..., 4] = 1.0 - t_carry
    out[..., 5] = t_carry
    return out, int(visits.sum()), int(blended)


def composite_forward_plain(packed, src, counts, starts, tiles_x, chunk=128):
    """The plain PyTorch version of K1; see composite_forward_plain_work."""
    return composite_forward_plain_work(
        packed, src, counts, starts, tiles_x, chunk
    )[0]


def composite_forward(packed, src, counts, starts, tiles_x, chunk=128):
    return composite_forward_plain(packed, src, counts, starts, tiles_x, chunk)


def composite_backward_plain(
    packed: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
    starts: torch.Tensor, tiles_x: int, fwd_out: torch.Tensor,
    grad_out: torch.Tensor, chunk: int = 128,
) -> torch.Tensor:
    """The plain PyTorch version of K2: per-entry gradient rows (e_pad, 10).

    The suffix identity of `csrc/composite_backward.cu` over the forward
    plain version's walk (`_plain_walk`):
    dL/dalpha_i = T_i u_i - S_i / max(1 - alpha_i, 1e-6), with S_i = phi -
    sum_{j<=i} w_j u_j and phi = C.gC + D gD + T_fin (gT - gA).  Slots
    outside every tile's segment, and entries no pixel blends, are zero.
    """
    g_c, g_d = grad_out[..., 0:3], grad_out[..., 3]
    s_rem = ((fwd_out[..., 0:3] * g_c).sum(-1) + fwd_out[..., 3] * g_d
             + fwd_out[..., 5] * (grad_out[..., 5] - grad_out[..., 4]))
    drows = torch.zeros((src.shape[0], NUM_FIELDS), device=packed.device)
    zero = torch.zeros((), device=packed.device)
    for ch in _plain_walk(packed, src, counts, starts, tiles_x, chunk):
        rows, dx, dy, alpha, w = ch.rows, ch.dx, ch.dy, ch.alpha, ch.w
        ca = rows[..., 2][:, None, :]
        cb = rows[..., 3][:, None, :]
        cc = rows[..., 4][:, None, :]
        u = (torch.einsum("tpc,tkc->tpk", g_c, rows[..., 5:8])
             + g_d[..., None] * rows[..., 9][:, None, :])
        wu = w * u
        s_after = s_rem[..., None] - torch.cumsum(wu, dim=-1)
        dalpha = torch.where(
            ch.composited,
            ch.t_excl * u - s_after / torch.clamp(1.0 - alpha, min=1e-6), zero)
        dpow = torch.where(alpha >= ALPHA_MAX, zero, alpha * dalpha)
        fields = torch.stack([
            (dpow * (ca * dx + cb * dy)).sum(1),
            (dpow * (cc * dy + cb * dx)).sum(1),
            (-0.5 * dpow * dx * dx).sum(1),
            (-dpow * dx * dy).sum(1),
            (-0.5 * dpow * dy * dy).sum(1),
            torch.einsum("tpk,tp->tk", w, g_c[..., 0]),
            torch.einsum("tpk,tp->tk", w, g_c[..., 1]),
            torch.einsum("tpk,tp->tk", w, g_c[..., 2]),
            dpow.sum(1) / torch.clamp(rows[..., 8], min=1e-9),
            torch.einsum("tpk,tp->tk", w, g_d),
        ], dim=-1)                                               # (t, k, 10)
        drows[ch.slot[ch.valid]] = fields[ch.valid]
        s_rem = s_rem - wu.sum(dim=-1)
    return drows


def composite_backward(packed, src, counts, starts, tiles_x, fwd_out,
                       grad_out, chunk=128):
    return composite_backward_plain(packed, src, counts, starts, tiles_x,
                                    fwd_out, grad_out, chunk)


def accumulate_rows(drows: torch.Tensor, bins: PrefixBins,
                    n_gauss: int) -> torch.Tensor:
    """Per-entry rows (e_pad, 10) in slot order -> per-Gaussian (g, 10).

    The rows are gathered into source order (`src_order`); dead and
    dropped positions carry segment id g.  "segsum" sums each Gaussian's
    run with `index_add_`; "segscan" runs K4 and reads each run's last
    lane at `ends - 1` (Gaussians with no entry get zero), falling back to
    the sum when the budget dropped entries, since the ends then no
    longer match the stream.
    """
    drows_s = drows[bins.src_order.long()]                     # (e_pad, 10)
    if ACCUM_MODE == "segscan" and not bool(bins.has_drops):
        scanned = segmented_scan_lanes(drows_s.T.contiguous(), bins.src_sorted)
        take = torch.clamp(bins.ends.long() - 1, 0, drows.shape[0] - 1)
        return torch.where((bins.live_counts > 0)[:, None], scanned[:, take].T,
                           torch.zeros((), device=drows.device))
    out = torch.zeros((n_gauss + 1, NUM_FIELDS), dtype=drows.dtype,
                      device=drows.device)
    return out.index_add_(0, bins.src_sorted.long(), drows_s)[:n_gauss]


class _PrefixComposite(torch.autograd.Function):
    """K1 forward; K2 and the per-Gaussian reduction backward."""

    @staticmethod
    def forward(ctx, packed, bins, tiles_x, chunk):
        out = composite_forward(packed, bins.src, bins.counts, bins.starts,
                                tiles_x, chunk)
        ctx.save_for_backward(packed, out)
        ctx.bins, ctx.tiles_x, ctx.chunk = bins, tiles_x, chunk
        return out

    @staticmethod
    def backward(ctx, grad_out):
        packed, out = ctx.saved_tensors
        bins = ctx.bins
        drows = composite_backward(packed, bins.src, bins.counts, bins.starts,
                                   ctx.tiles_x, out, grad_out.contiguous(),
                                   ctx.chunk)
        return accumulate_rows(drows, bins, packed.shape[0]), None, None, None


def untile(x: torch.Tensor, num_tiles_xy: tuple[int, int],
           image_shape: tuple[int, int]) -> torch.Tensor:
    """(n_tiles, 256, c) -> (h, w, c)."""
    tiles_y, tiles_x = num_tiles_xy
    h, w = image_shape
    c = x.shape[-1]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, c)
    return x[:h, :w]


def packed_rows(proj: ProjectedGaussians) -> torch.Tensor:
    """The kernels' (g, NUM_FIELDS) float32 rows; non-finite means and
    depths (Gaussians the binning leaves out) become 0."""
    depth_safe = torch.where(torch.isfinite(proj.depth), proj.depth,
                             torch.zeros_like(proj.depth))
    xy_safe = torch.where(torch.isfinite(proj.xy), proj.xy,
                          torch.zeros_like(proj.xy))
    return torch.cat(
        [xy_safe, proj.conic, proj.color, proj.opacity[:, None],
         depth_safe[:, None]],
        dim=-1,
    ).to(torch.float32).contiguous()


def composite_prefix(
    proj: ProjectedGaussians,
    bins: PrefixBins,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    chunk: int = 128,
):
    """Composite one camera; returns (color (h, w, 3), depth, alpha)."""
    tiles_y, tiles_x = bins.num_tiles_xy
    packed = packed_rows(proj)
    out = _PrefixComposite.apply(packed, bins, tiles_x, chunk)  # (n_tiles, 256, 8)
    color_t = out[..., 0:3] + out[..., 5:6] * background[None, None, :]
    return (
        untile(color_t, bins.num_tiles_xy, image_shape),
        untile(out[..., 3:4], bins.num_tiles_xy, image_shape)[..., 0],
        untile(out[..., 4:5], bins.num_tiles_xy, image_shape)[..., 0],
    )
