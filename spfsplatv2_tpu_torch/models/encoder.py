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
an input signature (`encoder_base.py:GraphedEncoder`).
`estimating_focal` adds the intrinsics estimated from view 0's pointmap
(`intrinsics_cwt`).  `CrocoHeads` holds the heads, their seeded init and
the pose post-processing, which the SPFSplat v1 encoder
(`encoder_spfsplat.py`) shares; the forward, the Gaussian assembly and
the pose normalisation are every encoder's (`encoder_base.py`).

Weights come from `utils/from_flax.py` (a flax param tree) or from
`init_weights(generator)`, a seeded init with the flax initializers'
rules (LeCun truncated normal, the heads' calibrated output layers).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils.checkpoint import checkpoint

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.geometry.intrinsics import estimate_intrinsics
from spfsplatv2_tpu_torch.models.adapter import raw_gaussian_channels
from spfsplatv2_tpu_torch.models.croco.backbone import (
    CrocoBackboneConfig,
    MaskedCrocoBackbone,
)
from spfsplatv2_tpu_torch.models.encoder_base import GraphedEncoder
from spfsplatv2_tpu_torch.models.heads.dpt import DPTGSHead, DPTHead
from spfsplatv2_tpu_torch.models.heads.pose_head import PoseHead, PoseHeadConfig
from spfsplatv2_tpu_torch.models.heads.postprocess import pts3d_postprocess
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


class CrocoHeads:
    """The CroCo encoders' heads (the flagship's and v1's): dual DPT
    pointmap and Gaussian heads over the context views and, with
    `estimating_pose`, dual MLP pose heads; their seeded init, their
    forward, the pose post-processing and, with `estimating_focal`, the
    estimated intrinsics.  List it before `Encoder`."""

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

    def _init_own(self, generator: torch.Generator) -> None:
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

    def _dpt_heads(self, dec_feat, grid, images, remat):
        """The context views' decoder features and normalised images ->
        (pts3d (b, v_cxt, h, w, 3), the raw Gaussian channels)."""
        raw_pts = self._run_dual_heads("downstream_head", dec_feat, grid,
                                       remat)
        return (pts3d_postprocess(raw_pts, mode="exp"),
                self._run_dual_heads("gaussian_param_head", dec_feat, grid,
                                     remat, extra=images))

    def _pose_pass(self, tokens: torch.Tensor, v_cxt: int) -> torch.Tensor:
        """tokens (b, v, n, c), pooled over n by the heads: head 1 on
        view 0, head 2 on the rest -> normalised c2w poses (b, v, 4, 4)."""
        b, v = tokens.shape[:2]
        p1 = self.pose_head1(tokens[:, 0])
        p2 = self.pose_head2(tokens[:, 1:].reshape(b * (v - 1), *tokens.shape[2:]))
        pose_enc = torch.cat([p1[:, None], p2.reshape(b, v - 1, 9)], dim=1)
        return self._normalize_poses(se3.pose_encoding_to_matrix(pose_enc),
                                     v_cxt)

    def _assemble(self, pts3d, *net, v_all: int, **kw) -> dict:
        """With `estimating_focal`, also view 0's estimated intrinsics for
        all `v_all` views."""
        out = super()._assemble(pts3d, *net, v_all=v_all, **kw)
        if self.cfg.estimating_focal:
            # View 0's camera frame is the world frame after the relative
            # normalization; its focal holds for every view.
            k_pred = estimate_intrinsics(pts3d)
            out["intrinsics_cwt"] = k_pred[:, None].expand(
                pts3d.shape[0], v_all, 3, 3)
        return out


class SPFSplatV2Encoder(CrocoHeads, GraphedEncoder):
    def __init__(self, cfg: SPFSplatV2Config = SPFSplatV2Config()):
        super().__init__()
        self.cfg = cfg
        self.backbone = MaskedCrocoBackbone(cfg.backbone)
        self._build_heads(cfg.backbone.dec_embed_dim)

    def _init_own(self, generator: torch.Generator) -> None:
        if self.cfg.backbone.pose_token:
            pt = self.backbone.pose_token
            pt.copy_(torch.randn(pt.shape, generator=generator,
                                 device=pt.device))
        super()._init_own(generator)

    def _network(self, *views):
        """Normalisation, backbone and heads -> (pts3d, the raw Gaussian
        channels, every view's c2w pose or None without
        `estimating_pose`)."""
        cfg = self.cfg
        v_cxt = views[0].shape[1]
        with span("encoder.backbone"):
            images, intrinsics, v_tgt, view_valid = self._views(*views)
            images = (images - cfg.input_mean) / cfg.input_std
            out = self.backbone(images, intrinsics, num_target=v_tgt,
                                view_valid=view_valid)
        with span("encoder.heads"):
            pts3d, raw_gs = self._dpt_heads(
                [t[:, :v_cxt] for t in out["dec_feat"]], out["grid"],
                images[:, :v_cxt], cfg.remat_heads)
            poses = None
            if cfg.estimating_pose:
                poses = self._pose_pass(out["pose_feat"][-1], v_cxt)
        return pts3d, raw_gs, poses
