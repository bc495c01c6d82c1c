"""Splatting decoder: Gaussians + cameras -> rendered images and depths
(torch port of `spfsplatv2_tpu/models/decoder.py`).

The JAX function vmaps the render over the batch; here it is a loop over
scenes, and `render` loops over cameras: one compositing launch per
rendered camera.  `decode_orthographic` renders through the same path
from cameras moved far back behind a tiny field of view.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.gaussians import Gaussians
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig, render
from spfsplatv2_tpu_torch.utils.profiling import span


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
    with span("decoder.render"):
        return _decode_splatting(gaussians, extrinsics, intrinsics, near, far,
                                 image_shape, cfg)


def _decode_splatting(gaussians, extrinsics, intrinsics, near, far,
                      image_shape, cfg: DecoderConfig) -> DecoderOutput:
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


def orthographic_cameras(
    extrinsics: torch.Tensor,   # (b, v, 4, 4) c2w
    width: torch.Tensor,        # (b, v) world-space view width
    height: torch.Tensor,       # (b, v) world-space view height
    near: torch.Tensor,         # (b, v)
    far: torch.Tensor,          # (b, v)
    fov_degrees: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The perspective cameras that fake an orthographic view: each camera
    moved back along its own -z by `distance`, where a `fov_degrees`
    frustum spans `width`, with the normalized pinhole K of that frustum
    and near/far moved back with it -> (extrinsics, intrinsics, near,
    far).

    The shift is the closed form of the JAX function's `extrinsics @
    shift`, t' = t - distance * R[:, 2], elementwise: as a matmul, a TF32
    setting anywhere in the process would round a translation of ~573 x
    width by ~1e-3 of itself."""
    tan_fov_x = math.tan(math.radians(fov_degrees) * 0.5)
    distance = (0.5 * width) / tan_fov_x
    tan_fov_y = 0.5 * height / distance
    t = extrinsics[..., :3, 3] - distance[..., None] * extrinsics[..., :3, 2]
    shifted = torch.cat([
        torch.cat([extrinsics[..., :3, :3], t[..., None]], dim=-1),
        extrinsics[..., 3:, :],
    ], dim=-2)
    k = torch.zeros((*extrinsics.shape[:2], 3, 3), dtype=extrinsics.dtype,
                    device=extrinsics.device)
    k[..., 0, 0] = 0.5 / tan_fov_x
    k[..., 1, 1] = 0.5 / tan_fov_y
    k[..., 0, 2] = 0.5
    k[..., 1, 2] = 0.5
    k[..., 2, 2] = 1.0
    return shifted, k, near + distance, far + distance


def decode_orthographic(
    gaussians: Gaussians,       # (b, g, ...)
    extrinsics: torch.Tensor,   # (b, v, 4, 4) c2w
    width: torch.Tensor,        # (b, v) world-space view width
    height: torch.Tensor,       # (b, v) world-space view height
    near: torch.Tensor,         # (b, v)
    far: torch.Tensor,          # (b, v)
    image_shape: tuple[int, int],
    cfg: DecoderConfig = DecoderConfig(),
    fov_degrees: float = 0.1,
) -> DecoderOutput:
    """Approximately orthographic rendering for figures (reference:
    render_cuda_orthographic, src/model/decoder/cuda_splatting.py:146-255):
    `decode_splatting` from `orthographic_cameras`, so the render runs K3
    twice and K1 once a camera, and K2 in its backward.

    Under `depth_key="quantized"` the binning keys each depth relative to
    the nearest live one ("relative"): moved back by ~573 x width, every
    depth shares its top float32 bits with its neighbours', and the
    quantized key would composite the scene in index order (JAX's
    function does; ROADMAP.md section 3)."""
    if cfg.rasterizer.depth_key == "quantized":
        cfg = dataclasses.replace(cfg, rasterizer=dataclasses.replace(
            cfg.rasterizer, depth_key="relative"))
    cams = orthographic_cameras(extrinsics, width, height, near, far,
                                fov_degrees)
    return decode_splatting(gaussians, *cams, image_shape, cfg)
