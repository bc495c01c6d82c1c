"""SPFSplatV2 encoder: unposed images -> pixel-aligned Gaussians + poses
(torch port of `spfsplatv2_tpu/models/encoder.py`).

Masked multi-view CroCo backbone over context (+ target) views; dual DPT
pointmap heads and dual DPT-GS heads over the context views (head 1 for
view 0, head 2 for the rest, folded into the batch); dual MLP pose heads
on the pose token; 6D -> SE3 pose post-processing relative to view 0; and
the unified Gaussian adapter.  `remat_heads` recomputes the DPT heads in
the backward pass (activation checkpointing, only while autograd
records), as the JAX config does.  In inference on the card (autograd
off, `eval()`) the backbone and heads replay a CUDA graph captured once
an input signature (`utils/cuda_graph.py`).  `estimating_focal` adds the
intrinsics estimated from view 0's pointmap (`intrinsics_cwt`).  The
SPFSplat v1 encoder (`encoder_spfsplat.py`) shares the heads, their
seeded init, the pose post-processing and the Gaussian assembly.

Weights come from `utils/from_flax.py` (a flax param tree) or from
`init_weights(generator)`, a seeded init with the flax initializers'
rules (LeCun truncated normal, the heads' calibrated output layers).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.geometry.intrinsics import estimate_intrinsics
from spfsplatv2_tpu_torch.models.adapter import (
    map_pdf_to_opacity,
    raw_gaussian_channels,
    unified_gaussian_adapter,
)
from spfsplatv2_tpu_torch.models.croco.backbone import (
    CrocoBackboneConfig,
    MaskedCrocoBackbone,
)
from spfsplatv2_tpu_torch.models.heads.dpt import DPTGSHead, DPTHead
from spfsplatv2_tpu_torch.models.heads.pose_head import PoseHead, PoseHeadConfig
from spfsplatv2_tpu_torch.models.heads.postprocess import pts3d_postprocess
from spfsplatv2_tpu_torch.utils.cuda_graph import GraphedNetwork
from spfsplatv2_tpu_torch.utils.init import lecun_normal_
from spfsplatv2_tpu_torch.utils.profiling import span


def dpt_hooks(dec_depth: int) -> tuple[int, ...]:
    """Hook layers [0, D/2, 3D/4, D]."""
    return (0, dec_depth * 2 // 4, dec_depth * 3 // 4, dec_depth)


@dataclass(frozen=True)
class OpacityMappingConfig:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


@dataclass(frozen=True)
class SPFSplatV2Config:
    backbone: CrocoBackboneConfig = field(default_factory=CrocoBackboneConfig)
    pose_head: PoseHeadConfig = field(default_factory=PoseHeadConfig)
    opacity_mapping: OpacityMappingConfig = field(
        default_factory=OpacityMappingConfig
    )
    sh_degree: int = 4
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    dpt_layer_dims: tuple[int, ...] = (96, 192, 384, 768)
    estimating_pose: bool = True
    estimating_focal: bool = False
    pose_make_baseline_1: bool = False
    pose_make_relative: bool = True
    input_mean: float = 0.5
    input_std: float = 0.5
    # Recompute the full-resolution DPT heads in the backward pass: their
    # conv activations dominate peak memory at the b=16 training batch.
    remat_heads: bool = True


class SPFSplatV2Encoder(GraphedNetwork, nn.Module):
    def __init__(self, cfg: SPFSplatV2Config = SPFSplatV2Config()):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = MaskedCrocoBackbone(bb)
        self._build_heads(bb.dec_embed_dim)

    def _build_heads(self, pose_dim: int) -> None:
        """The dual DPT pointmap and Gaussian heads (on the encoder
        features and 3 decoder layers) and, with `estimating_pose`, the
        dual pose heads on `pose_dim`-wide tokens."""
        cfg = self.cfg
        bb = cfg.backbone
        in_dims = (bb.enc_embed_dim,) + (bb.dec_embed_dim,) * 3
        gs_dim = raw_gaussian_channels(cfg.sh_degree)
        for s in ("1", "2"):
            setattr(self, f"downstream_head{s}", DPTHead(
                in_dims, out_channels=3, feature_dim=cfg.dpt_feature_dim,
                last_dim=cfg.dpt_last_dim, layer_dims=cfg.dpt_layer_dims,
            ))
            setattr(self, f"gaussian_param_head{s}", DPTGSHead(
                in_dims, out_channels=gs_dim, feature_dim=cfg.dpt_feature_dim,
                layer_dims=cfg.dpt_layer_dims,
            ))
            if cfg.estimating_pose:
                setattr(self, f"pose_head{s}", PoseHead(pose_dim, cfg.pose_head))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SPFSplatV2Encoder":
        """Seeded init following the flax module's initializers."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(mod.weight, generator,
                              transposed=isinstance(mod, nn.ConvTranspose2d))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if (isinstance(self.backbone, MaskedCrocoBackbone)
                and self.cfg.backbone.pose_token):
            pt = self.backbone.pose_token
            pt.copy_(torch.randn(pt.shape, generator=generator,
                                 device=pt.device))
        for s in ("1", "2"):
            # Calibrated from-scratch output layers (see the JAX heads).
            pts = getattr(self, f"downstream_head{s}").head_out
            lecun_normal_(pts.weight, generator, scale=0.01)
            pts.bias.copy_(torch.tensor([0.0, 0.0, 1.2]))
            gs = getattr(self, f"gaussian_param_head{s}").head_out
            lecun_normal_(gs.weight, generator, scale=0.01)
            if self.cfg.estimating_pose:
                ph = getattr(self, f"pose_head{s}")
                if self.cfg.pose_head.init_t:
                    ph.fc_t.weight.zero_()
                ph.fc_rot.weight.zero_()
                ph.fc_rot.bias.copy_(torch.tensor([1.0, 0, 0, 0, 1.0, 0]))
        return self

    def _run_dual_heads(self, prefix, dec_feat, grid, remat, extra=None):
        """head1 on view 0, head2 on views 1..v-1, recomputed in the
        backward pass when `remat`; returns (b, v, h, w, c)."""
        hooked = [dec_feat[i] for i in dpt_hooks(len(dec_feat) - 1)]
        b, v = hooked[0].shape[:2]

        def tokens_for(sel):
            return [t[:, sel].reshape(-1, *t.shape[2:]) for t in hooked]

        args1 = (tokens_for(slice(0, 1)), grid)
        args2 = (tokens_for(slice(1, v)), grid)
        if extra is not None:
            args1 += (extra[:, 0],)
            args2 += (extra[:, 1:].reshape(-1, *extra.shape[2:]),)
        def run(head, args):
            if remat and torch.is_grad_enabled():
                return checkpoint(head, *args, use_reentrant=False)
            return head(*args)

        out1 = run(getattr(self, f"{prefix}1"), args1)
        out2 = run(getattr(self, f"{prefix}2"), args2)
        return torch.cat([out1.reshape(b, 1, *out1.shape[1:]),
                          out2.reshape(b, v - 1, *out2.shape[1:])], dim=1)

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
        """The backbone and heads run as one CUDA graph replay in
        inference (CUDA inputs, autograd off, `eval()`: `_run_network`), and
        eagerly otherwise; the Gaussians are assembled eagerly."""
        pts3d, raw_gs, poses = self._run_network(
            (context_images, context_intrinsics, target_images,
             target_intrinsics, context_valid, target_valid))
        v_cxt = context_images.shape[1]
        v_tgt = 0 if target_images is None else target_images.shape[1]
        with span("encoder.gaussians"):
            return self._assemble(
                pts3d, raw_gs, None if poses is None else poses[:, :v_cxt],
                poses, global_step, v_cxt + v_tgt, context_valid)

    def _network(self, context_images, context_intrinsics, target_images,
                 target_intrinsics, context_valid, target_valid):
        """Normalisation, backbone and heads -> (pts3d (b, v_cxt, h, w, 3),
        the raw Gaussian channels (b, v_cxt, h, w, c), every view's c2w
        pose (b, v, 4, 4) or None without `estimating_pose`)."""
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
            images = (images - cfg.input_mean) / cfg.input_std

            view_valid = None
            if context_valid is not None or target_valid is not None:
                cv = (torch.ones((v_cxt,), device=dev) if context_valid is None
                      else context_valid.to(torch.float32))
                tv = (torch.ones((v_tgt,), device=dev) if target_valid is None
                      else target_valid.to(torch.float32))
                view_valid = torch.cat([cv, tv]) if v_tgt else cv

            out = self.backbone(images, intrinsics, num_target=v_tgt,
                                view_valid=view_valid)
        with span("encoder.heads"):
            dec_feat, pose_feat, grid = (out["dec_feat"], out["pose_feat"],
                                         out["grid"])
            ctx_feat = [t[:, :v_cxt] for t in dec_feat]
            raw_pts = self._run_dual_heads("downstream_head", ctx_feat, grid,
                                           cfg.remat_heads)
            # (b, v_cxt, h, w, 3)
            pts3d = pts3d_postprocess(raw_pts, mode="exp")
            raw_gs = self._run_dual_heads("gaussian_param_head", ctx_feat,
                                          grid, cfg.remat_heads,
                                          extra=images[:, :v_cxt])
            poses = None
            if cfg.estimating_pose:
                poses = self._process_pose(self._pose_pass(pose_feat[-1]),
                                           v_cxt)
        return pts3d, raw_gs, poses

    def _pose_pass(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (b, v, n, c), pooled over n by the heads: head 1 on
        view 0, head 2 on the rest -> 9D encodings (b, v, 9)."""
        b, v = tokens.shape[:2]
        p1 = self.pose_head1(tokens[:, 0])
        p2 = self.pose_head2(tokens[:, 1:].reshape(b * (v - 1), *tokens.shape[2:]))
        return torch.cat([p1[:, None], p2.reshape(b, v - 1, 9)], dim=1)

    def _assemble(self, pts3d, raw_gs, extrinsics_c, extrinsics_cwt,
                  global_step, v_all: int, context_valid=None) -> dict:
        """The encoder's output dict: Gaussians from the context views'
        points and raw head channels (opacities zeroed for dropped context
        views), depths from the context poses, and with `estimating_focal`
        view 0's estimated intrinsics for all `v_all` views."""
        cfg = self.cfg
        b, v_cxt, h, w, _ = pts3d.shape
        gs_dim = raw_gs.shape[-1]
        densities = torch.sigmoid(raw_gs[..., 0])
        om = cfg.opacity_mapping
        opacities = map_pdf_to_opacity(densities, global_step, om.initial,
                                       om.final, om.warm_up)
        if context_valid is not None:
            opacities = opacities * context_valid.to(opacities.dtype)[
                None, :, None, None
            ]
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
        out = {
            "gaussians": gaussians,
            "extrinsics_c": extrinsics_c,
            "extrinsics_cwt": extrinsics_cwt,
            "pts3d": pts3d,
            "depths": depths,
            "densities": densities,
        }
        if cfg.estimating_focal:
            # View 0's camera frame is the world frame after the relative
            # normalization; its focal holds for every view.
            k_pred = estimate_intrinsics(pts3d)
            out["intrinsics_cwt"] = k_pred[:, None].expand(b, v_all, 3, 3)
        return out

    def _process_pose(self, pose_enc: torch.Tensor, v_cxt: int) -> torch.Tensor:
        """9D encodings -> c2w poses, baseline-1 / relative normalization."""
        poses = se3.pose_encoding_to_matrix(pose_enc)       # (b, v, 4, 4)
        if self.cfg.pose_make_baseline_1:
            a = poses[:, 0, :3, 3]
            c = poses[:, v_cxt - 1, :3, 3]
            scale = torch.linalg.norm(a - c, dim=-1)[:, None, None]
            t = poses[:, :, :3, 3:] / torch.clamp(scale, min=1e-8)[..., None]
            poses = torch.cat([torch.cat([poses[:, :, :3, :3], t], dim=-1),
                               poses[:, :, 3:]], dim=-2)
        if self.cfg.pose_make_relative:
            poses = se3.camera_normalization(poses[:, 0:1], poses)
        return poses


def build_encoder(cfg: SPFSplatV2Config = SPFSplatV2Config(), seed: int = 0,
                  device: str | torch.device = "cuda") -> SPFSplatV2Encoder:
    """Construct the encoder on `device` and initialise it from a seeded
    `torch.Generator` on that device."""
    device = torch.device(device)
    with device:
        model = SPFSplatV2Encoder(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).eval()
