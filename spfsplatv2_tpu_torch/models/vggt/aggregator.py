"""VGGT aggregator: alternating frame and global attention with target
masking (torch port of `spfsplatv2_tpu/models/vggt/aggregator.py`).

  * DINOv2 patch tokens (`models/vggt/dinov2.py`);
  * per-view special tokens: the optional intrinsics token (Linear
    9 -> C) first, then a camera token and `num_register_tokens` register
    tokens, with separate learned rows for the first frame and the rest;
  * `depth` pairs of frame attention (each view alone) and global
    attention (all views' tokens concatenated), RoPE on the patch tokens
    at grid position + 1, the special tokens at 0;
  * the global attention's view-level mask: context rows cannot see
    target columns, and no row sees a view dropped through `view_valid`;
  * outputs: each layer's concat(frame, global) tokens, (b, v, p, 2C)
    float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch
from torch import nn

from spfsplatv2_tpu_torch.models.croco.layers import Dense
from spfsplatv2_tpu_torch.models.vggt.dinov2 import (
    DinoV2,
    DinoV2Config,
    check_flash_limits,
)
from spfsplatv2_tpu_torch.models.vggt.layers import VGGTBlock

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)


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

    @property
    def num_special(self) -> int:
        # intrinsics? + camera + registers
        return int(self.intrinsics_token) + 1 + self.num_register_tokens

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def global_view_mask_blocks(v: int, num_target: int, view_valid=None,
                            device=None) -> torch.Tensor:
    """(v, v) additive float32 view-level mask: context rows cannot see
    target columns; a view marked invalid in `view_valid` ((v,), randomly
    dropped) is blocked as a column for every row, as if sliced out."""
    idx = torch.arange(v, device=device)
    blocked = (idx[:, None] < v - num_target) & (idx[None, :] >= v - num_target)
    if view_valid is not None:
        blocked = blocked | ~view_valid.to(torch.bool)[None, :]
    return torch.where(blocked, float("-inf"), 0.0).to(torch.float32)


def global_view_mask(v: int, p: int, num_target: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """(v*p, v*p) token-level expansion of `global_view_mask_blocks`."""
    mask = global_view_mask_blocks(v, num_target, device=device).to(dtype)
    return mask.repeat_interleave(p, dim=0).repeat_interleave(p, dim=1)


@functools.lru_cache(maxsize=None)
def _resnet_mean_std(device: torch.device, dtype: torch.dtype):
    """RESNET_MEAN and RESNET_STD as tensors, made once a device and
    dtype: a copy from the host in each call would stall the stream and
    could not be captured in a CUDA graph."""
    return (torch.tensor(RESNET_MEAN, dtype=dtype, device=device),
            torch.tensor(RESNET_STD, dtype=dtype, device=device))


class VGGTAggregator(nn.Module):
    def __init__(self, cfg: AggregatorConfig = AggregatorConfig()):
        super().__init__()
        self.cfg = cfg
        c, cdt = cfg.embed_dim, cfg.dtype
        self.patch_embed = DinoV2(cfg.dinov2)
        self.camera_token = nn.Parameter(torch.zeros(2, 1, c))
        self.register_token = nn.Parameter(
            torch.zeros(2, cfg.num_register_tokens, c))
        if cfg.intrinsics_token:
            self.intrinsic_encoder = Dense(9, c)

        def blocks():
            return nn.ModuleList(
                VGGTBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.qk_norm,
                          cfg.init_values, cfg.rope_base, cdt)
                for _ in range(cfg.depth)
            )

        self.frame_blocks = blocks()
        self.global_blocks = blocks()

    def forward(self, images, intrinsics=None, num_target: int = 0,
                view_valid=None) -> dict:
        """images (b, v, h, w, 3) in [0, 1]; intrinsics (b, v, 3, 3)
        normalized; the trailing `num_target` views are targets.

        Returns {"tokens": [(b, v, p_total, 2C)] * depth float32,
        "patch_start": index of the first patch token, "grid": (gh, gw)}.
        """
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        c, dev = cfg.embed_dim, images.device
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        n_patch = gh * gw
        p_total = cfg.num_special + n_patch
        check_flash_limits(dev, cfg.dtype, p_total, c // cfg.num_heads,
                           "AggregatorConfig")

        mean, std = _resnet_mean_std(dev, torch.get_default_dtype())
        patch_tokens = self.patch_embed(
            ((images - mean) / std).reshape(b * v, h, w, 3))   # (b*v, p, C)

        def expand_special(tok):
            first = tok[0][None].expand(b, 1, *tok.shape[1:])
            rest = tok[1][None, None].expand(b, v - 1, *tok.shape[1:])
            return torch.cat([first, rest], dim=1).reshape(b * v, *tok.shape[1:])

        specials = [expand_special(self.camera_token),
                    expand_special(self.register_token)]
        if cfg.intrinsics_token:
            if intrinsics is None:
                raise ValueError("intrinsics are required by the intrinsics token")
            specials.insert(0, self.intrinsic_encoder(
                intrinsics.reshape(b * v, 9))[:, None, :])
        x = torch.cat(specials + [patch_tokens], dim=1)
        n_special = p_total - n_patch

        yy, xx = torch.meshgrid(
            torch.arange(gh, dtype=torch.int32, device=dev),
            torch.arange(gw, dtype=torch.int32, device=dev), indexing="ij")
        pos = torch.cat([
            torch.zeros((n_special, 2), dtype=torch.int32, device=dev),
            torch.stack([yy.reshape(-1), xx.reshape(-1)], -1) + 1])
        pos_frame = pos[None].expand(b * v, p_total, 2)
        pos_global = pos.repeat(v, 1)[None].expand(b, v * p_total, 2)
        # The view-level mask and the tokens per view: the attention
        # expands it, never materializing the (v*p)^2 token mask up front.
        gmask = (global_view_mask_blocks(v, num_target, view_valid, dev),
                 p_total)

        outputs = []
        for frame_blk, global_blk in zip(self.frame_blocks, self.global_blocks):
            x = frame_blk(x, pos_frame)
            frame_out = x
            xg = global_blk(x.reshape(b, v * p_total, c), pos_global, gmask)
            x = xg.reshape(b * v, p_total, c)
            outputs.append(torch.cat([frame_out, x], dim=-1).reshape(
                b, v, p_total, 2 * c).to(torch.float32))
        return {"tokens": outputs, "patch_start": n_special, "grid": (gh, gw)}
