"""Unmasked multi-view CroCo backbone, the SPFSplat v1 core (a frozen copy
of the port's `models/croco/backbone_multi.py`, plain).

ViT-L encoder shared across views, with each view's intrinsics token
appended at the encoder input at grid position (gh, 0); dual 12-block
decoders (`dec_blocks` for view 0, `dec_blocks2` for the rest) in which
every view cross-attends to every other view.  Target views are kept
apart by running the decoders twice: over the context views only (for
the pointmap, Gaussian and context pose heads) and over all views (for
the pose heads).  The blocks are the masked backbone's, with the
diagonal-only view mask; every attention is the dense form
(`reference/ops/attention.py`).

Departures from the published model (SPFSplat, ICCV; MASt3R's
ViTLarge_BaseDecoder under it): the published decoders cross-attend to
the concatenation of the other views' tokens; here one attention runs
over every view's tokens with the query's own view at -inf, which gives
the same softmax.  Everything runs in float32 (the configuration's
bfloat16 parts too), from seeded random weights, not MASt3R's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.models.croco.backbone import (
    MultiViewDecoderBlock,
    build_cross_view_mask,
)
from portbench.reference.models.croco.layers import (
    Dense,
    EncoderBlock,
    LayerNorm,
    PatchEmbed,
)


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
    # Recompute transformer blocks in the backward pass (activation
    # checkpointing, only while autograd records).
    remat: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


class CrocoMultiBackbone(nn.Module):
    def __init__(self, cfg: CrocoMultiBackboneConfig = CrocoMultiBackboneConfig()):
        super().__init__()
        self.cfg = cfg
        cdt = cfg.dtype
        e, d = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, e, cdt)
        if cfg.intrinsics_token:
            self.intrinsic_encoder = Dense(9, e)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(e, cfg.enc_num_heads, cfg.mlp_ratio, cfg.rope_base, cdt)
            for _ in range(cfg.enc_depth)
        )
        self.enc_norm = LayerNorm(e)
        self.decoder_embed = Dense(e, d)

        def dec(lo, hi):
            return nn.ModuleList(
                MultiViewDecoderBlock(d, cfg.dec_num_heads, cfg.mlp_ratio,
                                      cfg.rope_base, lo=lo, hi=hi,
                                      compute_dtype=cdt)
                for _ in range(cfg.dec_depth)
            )

        self.dec_blocks = dec(0, 1)
        self.dec_blocks2 = dec(1, None)
        self.dec_norm = LayerNorm(d)

    def _run(self, blk, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def _decode(self, x, pos, p: int) -> list:
        """The dual decoders over a subset of views, each attending to all
        the others: x (b, v, l, c_enc) -> [encoder features, decoder
        layers 1..D], patch tokens only, (b, v, p, c) float32."""
        view_mask = build_cross_view_mask(x.shape[1], 0, device=x.device)
        outputs = [x]
        f = self.decoder_embed(x)
        for blk0, blk_rest in zip(self.dec_blocks, self.dec_blocks2):
            f = torch.cat([self._run(blk0, f, pos, view_mask),
                           self._run(blk_rest, f, pos, view_mask)], dim=1)
            outputs.append(f)
        outputs[-1] = self.dec_norm(outputs[-1])
        return [o[:, :, :p].to(torch.float32) for o in outputs]

    def forward(self, images, intrinsics=None, num_target: int = 0) -> dict:
        """images (b, v, h, w, 3) normalized to [-1, 1]; intrinsics
        (b, v, 3, 3) normalized (required with the intrinsics token); the
        trailing `num_target` views are targets.

        Returns {"dec_feat": the context-only pass, "dec_feat_w_tgt": the
        all-views pass (None without targets), each a list of (b, v, p, c)
        float32, "grid": (gh, gw)}.
        """
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        p = gh * gw

        x, pos = self.patch_embed(images.reshape(b * v, h, w, 3))
        if cfg.intrinsics_token:
            if intrinsics is None:
                raise ValueError("intrinsics are required by the intrinsics token")
            tok = self.intrinsic_encoder(intrinsics.reshape(b * v, 1, 9))
            x = torch.cat([x, tok.to(x.dtype)], dim=1)
            # One row below the last patch row.
            extra = torch.tensor([[gh, 0]], dtype=pos.dtype, device=pos.device)
            pos = torch.cat([pos, extra[None].expand(b * v, 1, 2)], dim=1)
        for blk in self.enc_blocks:
            x = self._run(blk, x, pos)
        x = self.enc_norm(x)
        l = x.shape[1]
        x = x.reshape(b, v, l, cfg.enc_embed_dim)
        pos = pos.reshape(b, v, l, 2)

        v_cxt = v - num_target
        dec_feat = self._decode(x[:, :v_cxt], pos[:, :v_cxt], p)
        dec_feat_w_tgt = self._decode(x, pos, p) if num_target else None
        return {"dec_feat": dec_feat, "dec_feat_w_tgt": dec_feat_w_tgt,
                "grid": (gh, gw)}
