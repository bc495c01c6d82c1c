"""SPFSplat v1 encoder: the unmasked-backbone variant (torch port of
`spfsplatv2_tpu/models/encoder_spfsplat.py`).

The unmasked multi-view CroCo backbone runs its decoders twice, over the
context views (pointmaps, Gaussians, context poses) and over context and
target views (poses of every view).  The dual DPT pointmap and Gaussian
heads are the flagship's; the pose heads read the mean-pooled patch
tokens, the encoder's (1024-d) and the last decoder layer's (768-d)
concatenated, with homogeneous 4D translation and an un-zeroed `fc_t`.
Poses are rescaled to a unit baseline between views 0 and v_cxt - 1,
then made relative to view 0.  Both pose sets come back:
`extrinsics_c` from the context-only pass and `extrinsics_cwt` from the
pass with targets; the v1 loss reads both.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.models.croco.backbone_multi import (
    CrocoMultiBackbone,
    CrocoMultiBackboneConfig,
)
from spfsplatv2_tpu_torch.models.encoder import (
    OpacityMappingConfig,
    SPFSplatV2Encoder,
)
from spfsplatv2_tpu_torch.models.heads.pose_head import PoseHeadConfig
from spfsplatv2_tpu_torch.models.heads.postprocess import pts3d_postprocess
from spfsplatv2_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class SPFSplatConfig:
    backbone: CrocoMultiBackboneConfig = field(
        default_factory=CrocoMultiBackboneConfig
    )
    pose_head: PoseHeadConfig = field(
        default_factory=lambda: PoseHeadConfig(
            init_t=False, use_homogeneous=True, concat_enc=True
        )
    )
    opacity_mapping: OpacityMappingConfig = field(
        default_factory=OpacityMappingConfig
    )
    sh_degree: int = 4
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    dpt_layer_dims: tuple[int, ...] = (96, 192, 384, 768)
    estimating_pose: bool = True
    estimating_focal: bool = False
    pose_make_baseline_1: bool = True
    pose_make_relative: bool = True
    input_mean: float = 0.5
    input_std: float = 0.5


class SPFSplatEncoder(SPFSplatV2Encoder):
    """The flagship's heads, init, pose post-processing and Gaussian
    assembly over the unmasked backbone."""

    def __init__(self, cfg: SPFSplatConfig = SPFSplatConfig()):
        torch.nn.Module.__init__(self)
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = CrocoMultiBackbone(bb)
        self._build_heads(bb.enc_embed_dim + bb.dec_embed_dim)

    def forward(
        self,
        context_images: torch.Tensor,      # (b, v_cxt, h, w, 3) in [0, 1]
        context_intrinsics: torch.Tensor,  # (b, v_cxt, 3, 3) normalized
        target_images: torch.Tensor | None = None,
        target_intrinsics: torch.Tensor | None = None,
        global_step: int = 0,
    ) -> dict:
        cfg = self.cfg
        v_cxt = context_images.shape[1]
        v_tgt = 0 if target_images is None else target_images.shape[1]
        with span("encoder.backbone"):
            images, intrinsics = context_images, context_intrinsics
            if v_tgt:
                images = torch.cat([context_images, target_images], dim=1)
                intrinsics = torch.cat([context_intrinsics, target_intrinsics],
                                       dim=1)
            images = (images - cfg.input_mean) / cfg.input_std

            out = self.backbone(images, intrinsics, num_target=v_tgt)
        with span("encoder.heads"):
            dec_feat, grid = out["dec_feat"], out["grid"]
            # As in JAX, v1's heads keep their activations (no recompute).
            raw_pts = self._run_dual_heads("downstream_head", dec_feat, grid,
                                           remat=False)
            # (b, v_cxt, h, w, 3)
            pts3d = pts3d_postprocess(raw_pts, mode="exp")
            raw_gs = self._run_dual_heads("gaussian_param_head", dec_feat,
                                          grid, remat=False,
                                          extra=images[:, :v_cxt])

            extrinsics_c = extrinsics_cwt = None
            if cfg.estimating_pose:
                def poses(feats):
                    tokens = torch.cat([feats[0], feats[-1]], dim=-1)
                    return self._process_pose(self._pose_pass(tokens), v_cxt)

                extrinsics_c = extrinsics_cwt = poses(dec_feat)
                if out["dec_feat_w_tgt"] is not None:
                    extrinsics_cwt = poses(out["dec_feat_w_tgt"])
        with span("encoder.gaussians"):
            result = self._assemble(pts3d, raw_gs, extrinsics_c,
                                    extrinsics_cwt, global_step, v_cxt + v_tgt)
        result["variant"] = "spfsplat"
        return result


def build_encoder(cfg: SPFSplatConfig = SPFSplatConfig(), seed: int = 0,
                  device: str | torch.device = "cuda") -> SPFSplatEncoder:
    """Construct the encoder on `device` and initialise it from a seeded
    `torch.Generator` on that device."""
    device = torch.device(device)
    with device:
        model = SPFSplatEncoder(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).eval()
