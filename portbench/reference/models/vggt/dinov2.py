"""DINOv2 ViT feature extractor, the VGGT "patch embed" (torch port of
`spfsplatv2_tpu/models/vggt/dinov2.py`).

A 14x14 conv patch embed, a cls token and a learned position embedding
on the 37x37 pretraining grid, resized bicubically to the input's grid
(`utils/interp.py:resize_bicubic`, as `jax.image.resize` resizes),
`num_register_tokens` register tokens, pre-norm blocks with LayerScale
(no qk-norm, no RoPE) and a final LayerNorm; returns the patch tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.models.croco.layers import Conv, LayerNorm
from portbench.reference.models.vggt.layers import VGGTBlock
from portbench.reference.ops.attention import flash_limits_violation
from portbench.reference.utils.interp import resize_bicubic


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

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def check_flash_limits(device, dtype: torch.dtype, keys: int, head_dim: int,
                       where: str) -> None:
    """Raise before any computation when a per-view self-attention of
    `keys` keys would hand K5 what it does not take (see
    `ops/attention.py:flash_limits_violation`)."""
    reason = flash_limits_violation(device, dtype, [(keys, head_dim)])
    if reason is not None:
        raise ValueError(f"{reason}: set {where}.compute_dtype to 'bfloat16' "
                         f"or 'float32' and keep 64-wide heads, or use "
                         f"smaller images")


class DinoV2(nn.Module):
    def __init__(self, cfg: DinoV2Config = DinoV2Config()):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.remat = True  # see aggregator._block
        self.patch_embed = Conv(3, c, cfg.patch_size, stride=cfg.patch_size,
                                compute_dtype=cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.native_grid * cfg.native_grid + 1, c))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, c))
        self.blocks = nn.ModuleList(
            VGGTBlock(c, cfg.num_heads, cfg.mlp_ratio, qk_norm=False,
                      init_values=cfg.init_values, rope_base=None,
                      compute_dtype=cfg.dtype)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(c)

    def forward(self, images):
        """images (b, h, w, 3) normalized -> patch tokens (b, p, c) float32."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        p, c, g = cfg.patch_size, cfg.embed_dim, cfg.native_grid
        gh, gw = h // p, w // p
        check_flash_limits(images.device, cfg.dtype,
                           1 + cfg.num_register_tokens + gh * gw,
                           c // cfg.num_heads, "DinoV2Config")

        x = self.patch_embed(images.permute(0, 3, 1, 2))   # (b, c, gh, gw)
        x = x.flatten(2).transpose(1, 2)                     # (b, gh*gw, c)
        cls_pos = self.pos_embed[:, :1]
        patch_pos = self.pos_embed[:, 1:].reshape(1, g, g, c)
        if (gh, gw) != (g, g):
            patch_pos = resize_bicubic(patch_pos, (gh, gw))
        x = x + patch_pos.reshape(1, gh * gw, c)            # float32 from here
        cls = (self.cls_token + cls_pos).expand(b, 1, c)
        regs = self.register_tokens.expand(b, cfg.num_register_tokens, c)
        x = torch.cat([cls, regs, x], dim=1)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        x = self.norm(x)
        start = 1 + cfg.num_register_tokens
        return x[:, start: start + gh * gw]
