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
pass with targets; the v1 loss reads both.  The forward, the Gaussian
assembly and the pose normalisation are every encoder's
(`encoder_base.py`); v1 takes no view masks and no CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.models.croco.backbone_multi import (
    CrocoMultiBackbone,
    CrocoMultiBackboneConfig,
)
from spfsplatv2_tpu_torch.models.encoder import CrocoHeads, OpacityMappingConfig
from spfsplatv2_tpu_torch.models.encoder_base import Encoder
from spfsplatv2_tpu_torch.models.heads.pose_head import PoseHeadConfig
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


class SPFSplatEncoder(CrocoHeads, Encoder):
    """The flagship's heads over the unmasked backbone.

    Eager in every mode: its serving metric `serve.masked_logits_gib`
    reads a host-side counter (`ops/attention.py:sdpa_view_masked`) that
    a graph replay would not add to.  At 1024^2 the decoders'
    cross-attention takes the view-masked kernel, which moves no such
    counter, and the card waits on the eager host dispatch for about a
    third of a request: the time a graph replay would win there."""

    def __init__(self, cfg: SPFSplatConfig = SPFSplatConfig()):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = CrocoMultiBackbone(bb)
        self._build_heads(bb.enc_embed_dim + bb.dec_embed_dim)

    def _network(self, *views):
        """Normalisation, backbone and heads -> (pts3d, the raw Gaussian
        channels, the c2w poses of the pass with targets, those of the
        context-only pass; both None without `estimating_pose`)."""
        cfg = self.cfg
        v_cxt = views[0].shape[1]
        with span("encoder.backbone"):
            images, intrinsics, v_tgt, view_valid = self._views(*views)
            if view_valid is not None:
                raise TypeError("the SPFSplat v1 encoder drops no views: "
                                "it takes no context_valid or target_valid")
            images = (images - cfg.input_mean) / cfg.input_std
            out = self.backbone(images, intrinsics, num_target=v_tgt)
        with span("encoder.heads"):
            dec_feat = out["dec_feat"]
            # As in JAX, v1's heads keep their activations (no recompute).
            pts3d, raw_gs = self._dpt_heads(dec_feat, out["grid"],
                                            images[:, :v_cxt], remat=False)
            extrinsics_c = extrinsics_cwt = None
            if cfg.estimating_pose:
                def poses(feats):
                    tokens = torch.cat([feats[0], feats[-1]], dim=-1)
                    return self._pose_pass(tokens, v_cxt)

                extrinsics_c = extrinsics_cwt = poses(dec_feat)
                if out["dec_feat_w_tgt"] is not None:
                    extrinsics_cwt = poses(out["dec_feat_w_tgt"])
        return pts3d, raw_gs, extrinsics_cwt, extrinsics_c

    def _assemble(self, *net, **kw) -> dict:
        return {**super()._assemble(*net, **kw), "variant": "spfsplat"}
