"""Splatting decoder: Gaussians + cameras -> rendered images and depths
(torch port of `spfsplatv2_tpu/models/decoder.py:decode_splatting`).

The JAX function vmaps the render over the batch; here it is a loop over
scenes, and `render` loops over cameras: one compositing launch per
rendered camera.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.gaussians import Gaussians
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig, render


@dataclass(frozen=True)
class DecoderConfig:
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    make_scale_invariant: bool = True
    rasterizer: RasterizerConfig = field(
        default_factory=lambda: RasterizerConfig(entry_budget_factor=4.0)
    )


# The decoder of the long-context path (1024^2 views, where every
# self-attention takes flash attention): 2 x 1024^2 Gaussians need 21 bits
# of depth rank and 4096 tiles 13 bits of tile id, over the binning's
# 31-bit key, so the binning takes the quantized depth key, as the JAX
# package's error message directs (spfsplatv2_tpu/ops/raster_tiled.py).
LONG_CONTEXT_DECODER = DecoderConfig(rasterizer=RasterizerConfig(
    entry_budget_factor=4.0, depth_key="quantized"))


@dataclass
class DecoderOutput:
    color: torch.Tensor  # (b, v, h, w, 3)
    depth: torch.Tensor  # (b, v, h, w)
    alpha: torch.Tensor  # (b, v, h, w)
    dropped_entries: torch.Tensor | None = None  # (b, v) int32


def decode_splatting(
    gaussians: Gaussians,       # (b, g, ...)
    extrinsics: torch.Tensor,   # (b, v, 4, 4) c2w
    intrinsics: torch.Tensor,   # (b, v, 3, 3) normalized
    near: torch.Tensor,         # (b, v)
    far: torch.Tensor,          # (b, v)
    image_shape: tuple[int, int],
    cfg: DecoderConfig = DecoderConfig(),
) -> DecoderOutput:
    b, v = extrinsics.shape[:2]
    bg = torch.tensor(cfg.background_color, dtype=extrinsics.dtype,
                      device=extrinsics.device).expand(v, 3)
    raster_cfg = dataclasses.replace(
        cfg.rasterizer, scale_invariant=cfg.make_scale_invariant
    )
    outs = []
    for i in range(b):
        g = gaussians.map(lambda x: x[i])
        outs.append(render(
            extrinsics[i], intrinsics[i], near[i], far[i], image_shape, bg,
            g.means, g.covariances, g.harmonics, g.opacities, cfg=raster_cfg,
        ))
    depth = torch.stack([o.depth for o in outs])
    if cfg.make_scale_invariant:
        depth = depth * near[..., None, None]
    return DecoderOutput(
        color=torch.stack([o.color for o in outs]),
        depth=depth,
        alpha=torch.stack([o.alpha for o in outs]),
        dropped_entries=torch.stack([o.dropped_entries for o in outs]),
    )
