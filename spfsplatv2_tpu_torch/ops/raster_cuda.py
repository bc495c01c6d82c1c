"""Per-tile forward compositing over the prefix layout: kernel K1.

Counterpart of the forward half of `spfsplatv2_tpu/ops/raster_pallas.py`
(`_prefix_core` and `composite_pallas_prefix`).  The Pallas kernel
`_forward_kernel` becomes the hand-written CUDA kernel in
`csrc/composite_forward.cu`, which also fuses the `packed[src]` gather.

`composite_forward` takes the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors (or raises).  The composite is a
`torch.autograd.Function` whose backward raises: the backward kernel
(K2) is not ported yet, and inference runs under `torch.no_grad()`.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.raster_common import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    ProjectedGaussians,
)
from spfsplatv2_tpu_torch.ops.raster_tiled import PIX_PER_TILE, TILE, PrefixBins

NUM_FIELDS = 10  # [mx, my, conic a, b, c, r, g, b, opacity, depth]
OUT_FIELDS = 8   # [r, g, b, depth, 1 - T, T, 0, 0]


def composite_forward_plain_work(
    packed: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
    starts: torch.Tensor, tiles_x: int, chunk: int = 128,
) -> tuple[torch.Tensor, int, int]:
    """The plain version, plus the (pixel, entry) pairs this data needs.

    Tiles are batched: each step gathers entries [c0, c0 + chunk) of every
    tile's segment (masked past its count) and applies the CUDA break rule
    (a pixel stops for good at its first entry with T * (1 - alpha) <
    1e-4) with a cumulative product along the chunk.  Returns the
    (n_tiles, 256, 8) output, the pairs walked (every entry of a pixel up
    to and including the one that stopped it) and the pairs blended
    (composited with a non-zero weight).
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
    color = torch.zeros((n_tiles, PIX_PER_TILE, 3), device=dev)
    depth = torch.zeros((n_tiles, PIX_PER_TILE), device=dev)
    done = torch.zeros((n_tiles, PIX_PER_TILE), dtype=torch.bool, device=dev)
    visits = torch.zeros((n_tiles, PIX_PER_TILE), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
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
        color += torch.einsum("tpk,tkc->tpc", w, rows[..., 5:8])
        depth += torch.einsum("tpk,tk->tp", w, rows[..., 9])
        stopped = ((t_incl < T_EPS) & live).any(dim=-1)
        n_valid = valid.sum(dim=-1)[:, None].expand_as(visits)
        walked = torch.where(stopped, composited.sum(dim=-1) + 1, n_valid)
        visits += torch.where(done, torch.zeros_like(walked), walked)
        blended += (w > 0).sum()
        t_carry = torch.where(composited, t_incl, t_carry[..., None]).amin(dim=-1)
        done |= stopped
        if bool(done.all()):
            break
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


def composite_forward_cuda(
    packed: torch.Tensor, src: torch.Tensor, counts: torch.Tensor,
    starts: torch.Tensor, tiles_x: int,
) -> torch.Tensor:
    """Launch K1 on CUDA tensors; returns (n_tiles, 256, 8) float32.

    Precondition (as the binning guarantees): every entry of every tile's
    segment has 0 <= src < g.
    """
    dev = packed.device
    cuda_lib.require(packed, "packed", torch.float32, 2, dev)
    if packed.shape[1] != NUM_FIELDS:
        raise ValueError(f"packed: expected (g, {NUM_FIELDS}), got "
                         f"{tuple(packed.shape)}")
    cuda_lib.require(src, "src", torch.int32, 1, dev)
    cuda_lib.require(counts, "counts", torch.int32, 1, dev)
    cuda_lib.require(starts, "starts", torch.int32, 1, dev)
    n_tiles = counts.shape[0]
    if starts.shape[0] != n_tiles or n_tiles % tiles_x:
        raise ValueError(f"starts/counts/tiles_x disagree: {starts.shape[0]}, "
                         f"{n_tiles}, {tiles_x}")
    out = torch.empty((n_tiles, PIX_PER_TILE, OUT_FIELDS), dtype=torch.float32,
                      device=dev)
    fn = cuda_lib.library("composite_forward").spf_composite_forward
    err = fn(packed.data_ptr(), src.data_ptr(), counts.data_ptr(),
             starts.data_ptr(), n_tiles, tiles_x, out.data_ptr(),
             cuda_lib.stream_handle(dev))
    cuda_lib.launch_counts["composite_forward"] += 1
    cuda_lib.check(err, "composite_forward")
    return out


def composite_forward(packed, src, counts, starts, tiles_x, chunk=128):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if packed.is_cuda:
        return composite_forward_cuda(packed, src, counts, starts, tiles_x)
    return composite_forward_plain(packed, src, counts, starts, tiles_x, chunk)


class _PrefixComposite(torch.autograd.Function):
    """Forward compositing; the backward kernel is not ported yet."""

    @staticmethod
    def forward(ctx, packed, src, counts, starts, tiles_x, chunk):
        return composite_forward(packed, src, counts, starts, tiles_x, chunk)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "backward compositing kernel (K2) lands with the training slice"
        )


def untile(x: torch.Tensor, num_tiles_xy: tuple[int, int],
           image_shape: tuple[int, int]) -> torch.Tensor:
    """(n_tiles, 256, c) -> (h, w, c)."""
    tiles_y, tiles_x = num_tiles_xy
    h, w = image_shape
    c = x.shape[-1]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, c)
    return x[:h, :w]


def composite_prefix(
    proj: ProjectedGaussians,
    bins: PrefixBins,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    chunk: int = 128,
):
    """Composite one camera; returns (color (h, w, 3), depth, alpha)."""
    tiles_y, tiles_x = bins.num_tiles_xy
    depth_safe = torch.where(torch.isfinite(proj.depth), proj.depth,
                             torch.zeros_like(proj.depth))
    xy_safe = torch.where(torch.isfinite(proj.xy), proj.xy,
                          torch.zeros_like(proj.xy))
    packed = torch.cat(
        [xy_safe, proj.conic, proj.color, proj.opacity[:, None],
         depth_safe[:, None]],
        dim=-1,
    ).to(torch.float32).contiguous()                     # (g, NUM_FIELDS)
    out = _PrefixComposite.apply(packed, bins.src, bins.counts, bins.starts,
                                 tiles_x, chunk)     # (n_tiles, 256, 8)
    color_t = out[..., 0:3] + out[..., 5:6] * background[None, None, :]
    return (
        untile(color_t, bins.num_tiles_xy, image_shape),
        untile(out[..., 3:4], bins.num_tiles_xy, image_shape)[..., 0],
        untile(out[..., 4:5], bins.num_tiles_xy, image_shape)[..., 0],
    )
