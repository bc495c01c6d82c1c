"""SPFSplatV2-L encoder, the VGGT-1B variant (torch port of
`spfsplatv2_tpu/models/encoder_vggt.py`).

  * the VGGT aggregator (DINOv2/14 and alternating frame/global attention
    with the context -> target mask on the global attention) over the
    context (+ target) views;
  * the camera head: 4-iteration AdaLN refinement -> 9D [absT quat FoV]
    world-to-camera encoding -> c2w by the closed-form inverse ->
    baseline-1 / relative-to-view-0 normalization;
  * the point head on the context tokens only -> pixel-aligned points;
  * the DPT-GS head with the RGB skip -> raw Gaussian parameters;
  * the unified Gaussian adapter shared with the flagship.
No layer is recomputed in the backward pass (the JAX module has no remat).
In inference on the card (autograd off, `eval()`) the aggregator and
heads replay a CUDA graph captured once an input signature, as the
flagship's do (`encoder_base.py:GraphedEncoder`); the forward, the
Gaussian assembly and the pose normalisation are every encoder's.

Weights come from `utils/from_flax.py` (a flax param tree), from
`utils/ckpt_convert_vggt.py` (a reference VGGT state dict) or from
`init_weights(generator)`, a seeded init with the flax initializers'
rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models.adapter import raw_gaussian_channels
from spfsplatv2_tpu_torch.models.encoder import OpacityMappingConfig
from spfsplatv2_tpu_torch.models.encoder_base import GraphedEncoder
from spfsplatv2_tpu_torch.models.vggt.aggregator import (
    AggregatorConfig,
    VGGTAggregator,
)
from spfsplatv2_tpu_torch.models.vggt.camera_head import (
    CameraHead,
    CameraHeadConfig,
    pose_encoding_to_w2c,
)
from spfsplatv2_tpu_torch.models.vggt.dpt_head import VGGTDPTHead
from spfsplatv2_tpu_torch.utils.init import lecun_normal_
from spfsplatv2_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class SPFSplatV2LConfig:
    aggregator: AggregatorConfig = field(default_factory=AggregatorConfig)
    camera_head: CameraHeadConfig = field(default_factory=CameraHeadConfig)
    opacity_mapping: OpacityMappingConfig = field(
        default_factory=OpacityMappingConfig
    )
    sh_degree: int = 4
    estimating_pose: bool = True
    pose_make_baseline_1: bool = False
    pose_make_relative: bool = True


class SPFSplatV2LEncoder(GraphedEncoder):
    def __init__(self, cfg: SPFSplatV2LConfig = SPFSplatV2LConfig()):
        super().__init__()
        self.cfg = cfg
        agg = cfg.aggregator
        self.aggregator = VGGTAggregator(agg)
        if cfg.estimating_pose:
            self.camera_head = CameraHead(cfg.camera_head)
        dim = 2 * agg.embed_dim
        self.point_head = VGGTDPTHead(dim, output_dim=4,
                                      patch_size=agg.patch_size)
        self.gaussian_param_head = VGGTDPTHead(
            dim, output_dim=raw_gaussian_channels(cfg.sh_degree),
            patch_size=agg.patch_size, gs_variant=True)

    def _init_own(self, generator: torch.Generator) -> None:
        def normal_(t, std):
            t.copy_(std * torch.randn(t.shape, generator=generator,
                                      device=t.device))

        agg = self.aggregator
        normal_(agg.camera_token, 1e-6)
        normal_(agg.register_token, 1e-6)
        normal_(agg.patch_embed.pos_embed, 0.02)
        agg.patch_embed.cls_token.zero_()
        agg.patch_embed.register_tokens.zero_()
        if self.cfg.estimating_pose:
            self.camera_head.empty_pose_tokens.zero_()
        # The GS head's output conv starts small (gray colours, 0.5
        # opacity), as the flax module's 0.01 fan-in initializer does.
        lecun_normal_(self.gaussian_param_head.output_conv2_2.weight,
                      generator, scale=0.01)

    def _network(self, *views):
        """Aggregator and heads -> (pts3d, the raw Gaussian channels,
        every view's c2w pose or None without `estimating_pose`, the
        points' confidence (b, v_cxt, h, w)).  A dropped view also
        vanishes from the camera head's trunk."""
        cfg = self.cfg
        context_images = views[0]
        v_cxt = context_images.shape[1]
        with span("encoder.backbone"):
            images, intrinsics, v_tgt, view_valid = self._views(*views)
            agg = self.aggregator(images, intrinsics, num_target=v_tgt,
                                  view_valid=view_valid)
        with span("encoder.heads"):
            tokens, patch_start, grid = (agg["tokens"], agg["patch_start"],
                                         agg["grid"])
            poses = None
            if cfg.estimating_pose:
                pose_enc = self.camera_head(tokens[-1][:, :, 0],
                                            view_valid=view_valid)
                poses = self._normalize_poses(
                    se3.inverse_se3(pose_encoding_to_w2c(pose_enc)), v_cxt)

            ctx_tokens = [t[:, :v_cxt] for t in tokens]
            pts3d, conf = self.point_head(ctx_tokens, grid, patch_start)
            raw_gs = self.gaussian_param_head(ctx_tokens, grid, patch_start,
                                              images=context_images)
        return pts3d, raw_gs, poses, conf

    def _assemble(self, pts3d, raw_gs, poses, conf, **kw) -> dict:
        return {**super()._assemble(pts3d, raw_gs, poses, **kw),
                "pts3d_conf": conf}
