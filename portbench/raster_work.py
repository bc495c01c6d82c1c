"""What K1 and K2 must read on the data a launch is given, counted by the
benchmark's own code: the plain reference's projection, prefix binning and
front-to-back walk (`reference/ops/raster_common.py:project_gaussians`,
`raster_tiled.py:bin_gaussians_prefix`, `raster_cuda.py:_plain_walk`), run
on the program's Gaussians and cameras.

A tile's walk reaches its entries in depth order up to the one that stops
its last pixel (the kernels' rule: a pixel stops at its first entry with
T (1 - alpha) < 1e-4) or to its end.  Every Gaussian row that some tile's
walk reaches has to come from HBM at least once, and every tile entry
walked is a 4-byte index read.  Gaussians that no tile lists (behind the
camera, off screen, dropped by the entry budget) and entries behind the
point where a tile's pixels have all stopped are never read; a row listed
by many tiles is read at least once.  The (pixel, entry) pairs that the
walk blends (a non-zero weight) are the arithmetic that no kernel can skip.
`roofline.raster_least_s` turns the three counts into a launch's least
time, as the kernel table in PERF.md bounds K1 and K2.
"""

from __future__ import annotations

import torch

from portbench.reference.ops.raster_common import project_gaussians
from portbench.reference.ops.raster_cuda import _plain_walk, packed_rows
from portbench.reference.ops.raster_tiled import bin_gaussians_prefix
from portbench.reference.ops.rasterizer import entry_budget


@torch.no_grad()
def walk_work(packed, src, counts, starts, tiles_x: int,
              chunk: int = 128) -> tuple[int, int, int]:
    """(distinct rows reached, tile entries walked, pixel-entry pairs
    blended) of one launch over the prefix layout (`src`, `counts`,
    `starts`); the pairs as `composite_forward_plain_work` counts them."""
    g = packed.shape[0]
    reached = torch.zeros(g, dtype=torch.bool, device=packed.device)
    entries = torch.zeros((), dtype=torch.int64, device=packed.device)
    blended = torch.zeros((), dtype=torch.int64, device=packed.device)
    step = torch.arange(chunk, device=packed.device)
    for ch in _plain_walk(packed, src, counts, starts, tiles_x, chunk):
        # Each pixel's entries in this chunk up to the one that stops it,
        # none once it has stopped; a tile walks as far as its furthest.
        n_valid = ch.valid.sum(dim=-1)[:, None].expand_as(ch.done)
        walked = torch.where(ch.stopped, ch.composited.sum(dim=-1) + 1,
                             n_valid)
        extent = torch.where(ch.done, 0, walked).amax(dim=-1)
        take = ch.valid & (step[None, :] < extent[:, None])
        reached[src[ch.slot[take]].long()] = True
        entries += take.sum()
        blended += (ch.w > 0).sum()
    return int(reached.sum()), int(entries), int(blended)


@torch.no_grad()
def camera_work(gaussians: dict, c2w, intrinsics, near, image_shape,
                cfg, scale_invariant: bool) -> tuple[int, int, int]:
    """One camera's launch, as the reference's `render` prepares it:
    `gaussians` maps "means", "covariances", "harmonics" and "opacities"
    to one scene's (g, ...) tensors; `cfg` is the reference's
    `RasterizerConfig`."""
    means, covs, harmonics, opacities = (
        gaussians[k].float()
        for k in ("means", "covariances", "harmonics", "opacities"))
    c2w = c2w.float()
    if scale_invariant:
        scale = 1.0 / near.float()
        c2w = c2w.clone()
        c2w[:3, 3] = c2w[:3, 3] * scale
        means, covs = means * scale, covs * scale ** 2
    proj = project_gaussians(means, covs, harmonics, opacities, c2w,
                             intrinsics.float(), image_shape,
                             use_sh=cfg.use_sh)
    bins = bin_gaussians_prefix(
        proj, image_shape, cfg.max_tiles_per_gaussian, cfg.chunk,
        entry_budget(cfg, means.shape[0]),
        base_tiles_per_gaussian=cfg.base_tiles_per_gaussian,
        big_pool_factor=cfg.big_pool_factor, depth_key=cfg.depth_key)
    return walk_work(packed_rows(proj), bins.src, bins.counts, bins.starts,
                     bins.num_tiles_xy[1], cfg.chunk)


def render_work(gaussians: dict, extrinsics, intrinsics, near, image_shape,
                decoder_cfg) -> list[tuple[int, int, int]]:
    """(rows, entries, pairs) of each K1 launch of `decode_splatting` over
    (b, g, ...) Gaussians and (b, v) cameras, scene by scene and camera
    by camera; `decoder_cfg` is the reference's `DecoderConfig`."""
    b, v = extrinsics.shape[:2]
    return [camera_work({k: x[i] for k, x in gaussians.items()},
                        extrinsics[i, j], intrinsics[i, j], near[i, j],
                        image_shape, decoder_cfg.rasterizer,
                        decoder_cfg.make_scale_invariant)
            for i in range(b) for j in range(v)]
