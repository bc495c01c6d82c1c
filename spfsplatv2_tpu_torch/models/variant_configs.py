"""Config of the encoder variant that the port does not build yet (a
copy of the JAX package's plain config dataclasses), so that every
preset under `experiments/` loads: `SPFSplatConfig` (the v1 encoder,
`spfsplatv2_tpu/models/encoder_spfsplat.py`) with
`CrocoMultiBackboneConfig`.  Its modules are not ported (ROADMAP.md
item 17).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from spfsplatv2_tpu_torch.models.encoder import OpacityMappingConfig
from spfsplatv2_tpu_torch.models.heads.pose_head import PoseHeadConfig


@dataclass(frozen=True)
class CrocoMultiBackboneConfig:
    """ViTLarge_BaseDecoder, intrinsics token at the encoder."""

    patch_size: int = 16
    enc_depth: int = 24
    enc_embed_dim: int = 1024
    enc_num_heads: int = 16
    dec_depth: int = 12
    dec_embed_dim: int = 768
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    intrinsics_token: bool = True
    compute_dtype: str = "bfloat16"
    remat: bool = True


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
