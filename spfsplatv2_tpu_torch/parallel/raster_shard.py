"""Rasterizer sharding over the mesh's `tile` dim (torch port of
`spfsplatv2_tpu/parallel/raster_shard.py`).

Each rank of the `tile` dim renders a horizontal band of the image: a
principal-point and focal adjustment (`band_intrinsics`) maps the band to
a standalone render, so the band reuses the whole single-device
rasterizer and its kernels (K1 and K3, K2 in the backward).  The
Gaussians and cameras are replicated across the `tile` ranks and the
bands are all-gathered along the rows.

Gradients follow the JAX `shard_map` with replicated inputs: every rank
takes the same loss over the gathered image, the gather's backward hands
each band its own rows of the image's gradient (no sum: a sum over the
ranks would make every band's gradient `n_tile` times too large), and
the replicated inputs' gradients are summed over the `tile` ranks, so
each rank holds the single-device render's gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from spfsplatv2_tpu_torch.ops.rasterizer import (
    RasterizerConfig,
    RenderOutput,
    render,
)


def band_intrinsics(intrinsics: torch.Tensor, row_offset, band_h: int,
                    h: int) -> torch.Tensor:
    """Normalized intrinsics whose (band_h, w) render reproduces rows
    [row_offset, row_offset + band_h) of the full (h, w) render."""
    scale = h / band_h
    out = intrinsics.clone()
    out[..., 1, 1] = intrinsics[..., 1, 1] * scale
    out[..., 1, 2] = (intrinsics[..., 1, 2] * h - row_offset) / band_h
    return out


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums each input's gradient over
    `group` (one all-reduce of them all, in a fixed order)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return (None, *out)


class _GatherRows(torch.autograd.Function):
    """All-gather equal bands along dim 1 in rank order; the backward
    returns this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, group, band):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.band_h = band.shape[1]
        parts = [torch.empty_like(band)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, band.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.band_h
        return None, grad[:, lo:lo + ctx.band_h]


def render_tile_sharded(
    mesh,
    extrinsics: torch.Tensor,   # (cam, 4, 4)
    intrinsics: torch.Tensor,   # (cam, 3, 3) normalized
    near: torch.Tensor,
    far: torch.Tensor,
    image_shape: tuple[int, int],
    background: torch.Tensor,   # (cam, 3)
    means: torch.Tensor,        # (g, 3) shared across cameras
    covariances: torch.Tensor,
    harmonics: torch.Tensor,
    opacities: torch.Tensor,
    cfg: RasterizerConfig = RasterizerConfig(),
    sh_degree: int | None = None,
) -> RenderOutput:
    """`render` with the image's rows split over the `tile` ranks of
    `mesh`; every rank returns the whole (cam, h, w) image."""
    h, w = image_shape
    n_tile = mesh["tile"].size()
    assert h % (n_tile * 16) == 0, (
        f"image height {h} must split into 16px tile rows across {n_tile} "
        f"ranks")
    band_h = h // n_tile
    group = mesh["tile"].get_group()
    row_offset = mesh.get_local_rank("tile") * band_h

    inputs = (extrinsics, intrinsics, near, background, means, covariances,
              harmonics, opacities)
    grads = [i for i, t in enumerate(inputs) if t.requires_grad]
    if grads and torch.is_grad_enabled():
        summed = _SumGradients.apply(group, *(inputs[i] for i in grads))
        inputs = list(inputs)
        for i, t in zip(grads, summed):
            inputs[i] = t
    extr, intr, nr, bg, m, c, hm, op = inputs
    out = render(extr, band_intrinsics(intr, row_offset, band_h, h), nr, far,
                 (band_h, w), bg, m, c, hm, op, sh_degree=sh_degree,
                 cfg=cfg, ewa_reference_shape=(h, w))
    band = torch.cat([out.color, out.depth[..., None], out.alpha[..., None]],
                     dim=-1)
    full = _GatherRows.apply(group, band)
    return RenderOutput(color=full[..., :3], depth=full[..., 3],
                        alpha=full[..., 4])
