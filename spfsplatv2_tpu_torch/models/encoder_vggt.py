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
flagship's do (`utils/cuda_graph.py`).

Weights come from `utils/from_flax.py` (a flax param tree), from
`utils/ckpt_convert_vggt.py` (a reference VGGT state dict) or from
`init_weights(generator)`, a seeded init with the flax initializers'
rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models.adapter import (
    map_pdf_to_opacity,
    raw_gaussian_channels,
    unified_gaussian_adapter,
)
from spfsplatv2_tpu_torch.models.encoder import OpacityMappingConfig
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
from spfsplatv2_tpu_torch.models.vggt.layers import LayerScale
from spfsplatv2_tpu_torch.utils.cuda_graph import GraphedNetwork
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


class SPFSplatV2LEncoder(GraphedNetwork, nn.Module):
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

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SPFSplatV2LEncoder":
        """Seeded init following the flax module's initializers."""
        def normal_(t, std):
            t.copy_(std * torch.randn(t.shape, generator=generator,
                                      device=t.device))

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(mod.weight, generator,
                              transposed=isinstance(mod, nn.ConvTranspose2d))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm) and mod.elementwise_affine:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, LayerScale):
                mod.gamma.fill_(mod.init_value)
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
        return self

    def forward(
        self,
        context_images: torch.Tensor,      # (b, v_cxt, h, w, 3) in [0, 1]
        context_intrinsics: torch.Tensor,  # (b, v_cxt, 3, 3) normalized
        target_images: torch.Tensor | None = None,
        target_intrinsics: torch.Tensor | None = None,
        global_step: int = 0,
        context_valid: torch.Tensor | None = None,  # (v_cxt,)
        target_valid: torch.Tensor | None = None,   # (v_tgt,)
    ) -> dict:
        """`context_valid` / `target_valid` drop views with static shapes:
        a dropped view vanishes from the global attention and the camera
        head's trunk, and its Gaussians get zero opacity.  The aggregator
        and heads run as one CUDA graph replay in inference (CUDA inputs,
        autograd off, `eval()`: `_run_network`), and eagerly otherwise;
        the Gaussians are assembled eagerly."""
        pts3d, conf, raw_gs, poses = self._run_network(
            (context_images, context_intrinsics, target_images,
             target_intrinsics, context_valid, target_valid))
        with span("encoder.gaussians"):
            return self._assemble(pts3d, conf, raw_gs, poses, global_step,
                                  context_valid)

    def _assemble(self, pts3d, conf, raw_gs, poses, global_step,
                  context_valid=None) -> dict:
        """The encoder's output dict: Gaussians from the context views'
        points and raw head channels (opacities zeroed for dropped context
        views), depths from the context poses."""
        cfg = self.cfg
        b, v_cxt, h, w, _ = pts3d.shape
        extrinsics_c = None if poses is None else poses[:, :v_cxt]
        densities = torch.sigmoid(raw_gs[..., 0])
        om = cfg.opacity_mapping
        opacities = map_pdf_to_opacity(densities, global_step, om.initial,
                                       om.final, om.warm_up)
        if context_valid is not None:
            opacities = opacities * context_valid.to(opacities.dtype)[
                None, :, None, None
            ]
        gs_dim = raw_gaussian_channels(cfg.sh_degree)
        gaussians = unified_gaussian_adapter(
            pts3d.reshape(b, v_cxt, h * w, 3),
            opacities.reshape(b, v_cxt, h * w),
            raw_gs[..., 1:].reshape(b, v_cxt, h * w, gs_dim - 1),
            sh_degree=cfg.sh_degree,
        ).flatten_views()

        depths = None
        if extrinsics_c is not None:
            depths = se3.depth_from_pose(
                pts3d.reshape(b, v_cxt, h * w, 3), extrinsics_c
            ).reshape(b, v_cxt, h, w)
        return {
            "gaussians": gaussians,
            "extrinsics_c": extrinsics_c,
            "extrinsics_cwt": poses,
            "pts3d": pts3d,
            "pts3d_conf": conf,
            "depths": depths,
            "densities": densities,
        }

    def _network(self, context_images, context_intrinsics, target_images,
                 target_intrinsics, context_valid, target_valid):
        """Aggregator and heads -> (pts3d (b, v_cxt, h, w, 3), their
        confidence (b, v_cxt, h, w), the raw Gaussian channels (b, v_cxt,
        h, w, c), every view's c2w pose (b, v, 4, 4) or None without
        `estimating_pose`)."""
        cfg = self.cfg
        v_cxt = context_images.shape[1]
        v_tgt = 0 if target_images is None else target_images.shape[1]
        dev = context_images.device

        with span("encoder.backbone"):
            images, intrinsics = context_images, context_intrinsics
            if v_tgt:
                images = torch.cat([context_images, target_images], dim=1)
                intrinsics = torch.cat([context_intrinsics, target_intrinsics],
                                       dim=1)

            view_valid = None
            if context_valid is not None or target_valid is not None:
                cv = (torch.ones((v_cxt,), device=dev) if context_valid is None
                      else context_valid.to(torch.float32))
                tv = (torch.ones((v_tgt,), device=dev) if target_valid is None
                      else target_valid.to(torch.float32))
                view_valid = torch.cat([cv, tv]) if v_tgt else cv

            agg = self.aggregator(images, intrinsics, num_target=v_tgt,
                                  view_valid=view_valid)
        with span("encoder.heads"):
            tokens, patch_start, grid = (agg["tokens"], agg["patch_start"],
                                         agg["grid"])
            poses = None
            if cfg.estimating_pose:
                pose_enc = self.camera_head(tokens[-1][:, :, 0],
                                            view_valid=view_valid)
                poses = se3.inverse_se3(pose_encoding_to_w2c(pose_enc))
                poses = self._normalize_poses(poses, v_cxt)

            ctx_tokens = [t[:, :v_cxt] for t in tokens]
            pts3d, conf = self.point_head(ctx_tokens, grid, patch_start)
            raw_gs = self.gaussian_param_head(ctx_tokens, grid, patch_start,
                                              images=context_images)
        return pts3d, conf, raw_gs, poses

    def _normalize_poses(self, poses: torch.Tensor, v_cxt: int) -> torch.Tensor:
        """Baseline-1 rescale and relative-to-view-0 normalization."""
        if self.cfg.pose_make_baseline_1:
            a = poses[:, 0, :3, 3]
            c = poses[:, v_cxt - 1, :3, 3]
            scale = torch.linalg.norm(a - c, dim=-1)[:, None, None]
            poses = poses.clone()
            poses[:, :, :3, 3] = poses[:, :, :3, 3] / torch.clamp(scale, min=1e-8)
        if self.cfg.pose_make_relative:
            poses = se3.camera_normalization(poses[:, 0:1], poses)
        return poses


def build_encoder(cfg: SPFSplatV2LConfig = SPFSplatV2LConfig(), seed: int = 0,
                  device: str | torch.device = "cuda") -> SPFSplatV2LEncoder:
    """Construct the encoder on `device` and initialise it from a seeded
    `torch.Generator` on that device."""
    device = torch.device(device)
    with device:
        model = SPFSplatV2LEncoder(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).eval()
