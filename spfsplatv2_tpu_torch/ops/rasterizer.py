"""Public rasterizer API, batched over cameras (torch port of
`spfsplatv2_tpu/ops/rasterizer.py`).

Backends:
  * "prefix"    -- project, prefix binning, then per-tile compositing
                   (`raster_cuda.composite_prefix`: kernel K1 on CUDA, its
                   plain version on CPU).  The JAX package's "pallas"
                   backend; "auto", the default, selects it on every
                   device (the JAX package's "auto" takes "tiled" off the
                   TPU).
  * "tiled"     -- tile-binned plain torch (`raster_tiled.bin_gaussians`,
                   `composite_tiles`), differentiable by autograd, no
                   kernel; each tile composites its front-most
                   `max_per_tile` entries and the rest are counted as
                   dropped.
  * "reference" -- the dense O(pixels x gaussians) oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops.raster_cuda import composite_prefix
from spfsplatv2_tpu_torch.ops.raster_ref import composite_reference
from spfsplatv2_tpu_torch.ops.raster_tiled import (
    bin_gaussians,
    bin_gaussians_prefix,
    composite_tiles,
)
from spfsplatv2_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class RasterizerConfig:
    backend: str = "auto"
    max_tiles_per_gaussian: int = 16
    # The "tiled" backend's per-tile entry cap.
    max_per_tile: int = 2048
    chunk: int = 128
    scale_invariant: bool = True
    use_sh: bool = True
    # Live-entry budget; None = g * max_tiles_per_gaussian.  The factor
    # expresses it relative to g; an absolute budget wins.
    entry_budget: int | None = None
    entry_budget_factor: float | None = None
    # Two-tier expansion: base slots per gaussian, the rest from a pool of
    # g * big_pool_factor rows.  None = single-tier.
    base_tiles_per_gaussian: int | None = 4
    big_pool_factor: float = 0.125
    # The prefix binning's depth key: "rank", "quantized" or "relative"
    # (`raster_tiled.bin_gaussians_prefix`).
    depth_key: str = "rank"


@dataclass
class RenderOutput:
    color: torch.Tensor  # (..., h, w, 3)
    depth: torch.Tensor  # (..., h, w)
    alpha: torch.Tensor  # (..., h, w)
    # (cam,) int32 live tile entries dropped by the entry budget or pool.
    dropped_entries: torch.Tensor | None = None


def entry_budget(cfg: RasterizerConfig, g: int) -> int:
    """The JAX package's budget rounding: capped, then up to 128."""
    budget = cfg.entry_budget
    if budget is None and cfg.entry_budget_factor is not None:
        budget = int(cfg.entry_budget_factor * g)
    if budget is None:
        budget = g * cfg.max_tiles_per_gaussian
    return -(-min(budget, g * cfg.max_tiles_per_gaussian) // 128) * 128


def _render_one(means, covariances, harmonics, opacities, c2w, intrinsics,
                background, image_shape, sh_degree, cfg: RasterizerConfig,
                ewa_reference_shape=None):
    with span("render.project"):
        proj = project_gaussians(
            means, covariances, harmonics, opacities, c2w, intrinsics,
            image_shape, sh_degree=sh_degree, use_sh=cfg.use_sh,
            ewa_reference_shape=ewa_reference_shape,
        )
    dropped = torch.zeros((), dtype=torch.int32, device=means.device)
    if cfg.backend == "reference":
        with span("render.composite"):
            color, depth, alpha = composite_reference(proj, image_shape,
                                                      background)
    elif cfg.backend == "tiled":
        with span("render.bin"):
            bins = bin_gaussians(proj, image_shape, cfg.max_tiles_per_gaussian)
            diff = bins.tile_starts[1:] - bins.tile_starts[:-1]
            dropped = torch.clamp(diff - cfg.max_per_tile, min=0).sum().to(
                torch.int32)
        with span("render.composite"):
            color, depth, alpha = composite_tiles(
                proj, bins, image_shape, background,
                max_per_tile=cfg.max_per_tile, chunk=cfg.chunk,
            )
    elif cfg.backend in ("auto", "prefix"):
        with span("render.bin"):
            bins = bin_gaussians_prefix(
                proj, image_shape, cfg.max_tiles_per_gaussian, cfg.chunk,
                entry_budget(cfg, means.shape[0]),
                base_tiles_per_gaussian=cfg.base_tiles_per_gaussian,
                big_pool_factor=cfg.big_pool_factor,
                depth_key=cfg.depth_key,
                key_shape=ewa_reference_shape,
            )
        dropped = bins.n_overflow
        with span("render.composite"):
            color, depth, alpha = composite_prefix(
                proj, bins, image_shape, background, chunk=cfg.chunk,
            )
    else:
        raise ValueError(f"unknown rasterizer backend {cfg.backend!r}")
    return color, depth, alpha, dropped


def render(
    extrinsics: torch.Tensor,   # (cam, 4, 4) camera-to-world
    intrinsics: torch.Tensor,   # (cam, 3, 3) normalized
    near: torch.Tensor,         # (cam,)
    far: torch.Tensor,          # (cam,)
    image_shape: tuple[int, int],
    background: torch.Tensor,   # (cam, 3)
    means: torch.Tensor,        # (cam, g, 3) or (g, 3) shared
    covariances: torch.Tensor,  # (cam, g, 3, 3) or (g, 3, 3)
    harmonics: torch.Tensor,    # (cam, g, 3, d_sh) or (g, 3, d_sh)
    opacities: torch.Tensor,    # (cam, g) or (g,)
    sh_degree: int | None = None,
    cfg: RasterizerConfig = RasterizerConfig(),
    ewa_reference_shape: tuple[int, int] | None = None,
) -> RenderOutput:
    """Render a batch of cameras over shared or per-camera Gaussian sets.

    `scale_invariant` rescales the world by 1/near per camera before
    rendering; depth is returned in the rescaled world.  The rescaled
    means and covariances are made one camera at a time, inside the loop:
    the same float32 products as a batch of them, so the same bits, but a
    video over shared Gaussians holds one camera's copy, not all of them.
    `ewa_reference_shape`: the full image of which this render is a band
    of rows.  Its frustum bounds the EWA clamp (`project_gaussians`) and
    its tile count sets the binning key's depth bits
    (`bin_gaussians_prefix`), so that the band reproduces those rows of
    the full render.
    """
    del far  # the rasterizer has no far plane (as in the JAX package)
    shared = means.ndim == 2
    n_cam = extrinsics.shape[0]
    if cfg.scale_invariant:
        scale = 1.0 / near
        scale_sq = scale ** 2
        extrinsics = extrinsics.clone()
        extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * scale[:, None]

    outs = []
    for i in range(n_cam):
        sel = (lambda x: x) if shared else (lambda x: x[i])
        m, c = sel(means), sel(covariances)
        if cfg.scale_invariant:
            m, c = m * scale[i], c * scale_sq[i]
        outs.append(_render_one(
            m, c, sel(harmonics), sel(opacities),
            extrinsics[i], intrinsics[i], background[i], image_shape,
            sh_degree, cfg, ewa_reference_shape,
        ))
    return RenderOutput(
        color=torch.stack([o[0] for o in outs]),
        depth=torch.stack([o[1] for o in outs]),
        alpha=torch.stack([o[2] for o in outs]),
        dropped_entries=torch.stack([o[3] for o in outs]),
    )
