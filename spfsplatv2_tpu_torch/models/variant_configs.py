"""Configs of the encoder variants that the port does not build yet
(copies of the JAX package's plain config dataclasses), so that every
preset under `experiments/` loads:
  * `SPFSplatConfig` (the v1 encoder, `spfsplatv2_tpu/models/
    encoder_spfsplat.py`) with `CrocoMultiBackboneConfig`;
  * `SPFSplatV2LConfig` (the VGGT-1B encoder, `spfsplatv2_tpu/models/
    encoder_vggt.py`) with `AggregatorConfig`, `DinoV2Config` and
    `CameraHeadConfig`.
Their modules are not ported (ROADMAP.md items 16 and 17).
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


@dataclass(frozen=True)
class DinoV2Config:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    native_grid: int = 37  # 518 / 14, the pretraining grid for pos embed
    init_values: float = 1.0
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class AggregatorConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_base: float = 100.0
    init_values: float = 0.01
    intrinsics_token: bool = True   # intrinsics_embed_loc='decoder'
    dinov2: DinoV2Config = field(default_factory=DinoV2Config)
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    num_iterations: int = 4
    target_dim: int = 9


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
