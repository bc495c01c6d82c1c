"""Test-time pose alignment: optimize target extrinsics through the renderer
(torch port of `spfsplatv2_tpu/evaluation/pose_align.py`).

With the Gaussians fixed, each predicted target pose is refined by Adam on
the photometric MSE, with gradients flowing through the rasterizer (K2 on
the card) into the camera.  The pose is an SE(3) tangent delta around the
prediction, so the optimisation stays on the manifold.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.gaussians import Gaussians
from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting


def align_poses(
    gaussians: Gaussians,              # (b, g, ...)
    init_extrinsics: torch.Tensor,     # (b, v, 4, 4) predicted target poses
    intrinsics: torch.Tensor,          # (b, v, 3, 3)
    near: torch.Tensor,                # (b, v)
    far: torch.Tensor,                 # (b, v)
    target_images: torch.Tensor,       # (b, v, h, w, 3)
    image_shape: tuple[int, int],
    steps: int = 100,
    lr: float = 5e-4,
    decoder_cfg: DecoderConfig = DecoderConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (refined extrinsics (b, v, 4, 4), the last step's loss),
    the loss being the one evaluated before the last update, as in JAX."""
    gaussians = gaussians.map(lambda x: x.detach())
    init_extrinsics = init_extrinsics.detach()
    b, v = init_extrinsics.shape[:2]
    delta = torch.zeros((b, v, 6), dtype=init_extrinsics.dtype,
                        device=init_extrinsics.device, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = torch.zeros((), device=init_extrinsics.device)
    with torch.enable_grad():
        for _ in range(steps):
            out = decode_splatting(gaussians, se3.se3_exp(delta) @ init_extrinsics,
                                   intrinsics, near, far, image_shape,
                                   decoder_cfg)
            loss = torch.mean((out.color - target_images) ** 2)
            opt.zero_grad()
            loss.backward()
            opt.step()
    with torch.no_grad():
        return se3.se3_exp(delta) @ init_extrinsics, loss.detach()
