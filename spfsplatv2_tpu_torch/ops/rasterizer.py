"""Public rasterizer API, batched over cameras (torch port of
`spfsplatv2_tpu/ops/rasterizer.py`).

Backends:
  * "prefix"    -- project, prefix binning, then per-tile compositing
                   (`raster_cuda.composite_prefix`: kernel K1 on CUDA, its
                   plain version on CPU).  The JAX package's "pallas"
                   backend; the default.
  * "reference" -- the dense O(pixels x gaussians) oracle.
The JAX package's pure-XLA "tiled" backend is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops.raster_cuda import composite_prefix
from spfsplatv2_tpu_torch.ops.raster_ref import composite_reference
from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix


@dataclass(frozen=True)
class RasterizerConfig:
    backend: str = "prefix"
    max_tiles_per_gaussian: int = 16
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
                background, image_shape, sh_degree, cfg: RasterizerConfig):
    proj = project_gaussians(
        means, covariances, harmonics, opacities, c2w, intrinsics,
        image_shape, sh_degree=sh_degree, use_sh=cfg.use_sh,
    )
    dropped = torch.zeros((), dtype=torch.int32, device=means.device)
    if cfg.backend == "reference":
        color, depth, alpha = composite_reference(proj, image_shape, background)
    elif cfg.backend == "prefix":
        bins = bin_gaussians_prefix(
            proj, image_shape, cfg.max_tiles_per_gaussian, cfg.chunk,
            entry_budget(cfg, means.shape[0]),
            base_tiles_per_gaussian=cfg.base_tiles_per_gaussian,
            big_pool_factor=cfg.big_pool_factor,
            depth_key=cfg.depth_key,
        )
        dropped = bins.n_overflow
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
) -> RenderOutput:
    """Render a batch of cameras over shared or per-camera Gaussian sets.

    `scale_invariant` rescales the world by 1/near per camera before
    rendering; depth is returned in the rescaled world.
    """
    del far  # the rasterizer has no far plane (as in the JAX package)
    shared = means.ndim == 2
    n_cam = extrinsics.shape[0]
    if cfg.scale_invariant:
        scale = 1.0 / near
        extrinsics = extrinsics.clone()
        extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * scale[:, None]
        if shared:
            means = means[None] * scale[:, None, None]
            covariances = covariances[None] * (scale[:, None, None, None] ** 2)
            harmonics = harmonics[None].expand(n_cam, *harmonics.shape)
            opacities = opacities[None].expand(n_cam, *opacities.shape)
            shared = False
        else:
            means = means * scale[:, None, None]
            covariances = covariances * (scale[:, None, None, None] ** 2)

    outs = []
    for i in range(n_cam):
        sel = (lambda x: x) if shared else (lambda x: x[i])
        outs.append(_render_one(
            sel(means), sel(covariances), sel(harmonics), sel(opacities),
            extrinsics[i], intrinsics[i], background[i], image_shape,
            sh_degree, cfg,
        ))
    return RenderOutput(
        color=torch.stack([o[0] for o in outs]),
        depth=torch.stack([o[1] for o in outs]),
        alpha=torch.stack([o[2] for o in outs]),
        dropped_entries=torch.stack([o[3] for o in outs]),
    )
