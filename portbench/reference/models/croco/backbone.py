"""Masked multi-view CroCo backbone (torch port of
`spfsplatv2_tpu/models/croco/backbone.py`).

ViT-L encoder shared across views; dual masked decoders (`dec_blocks` for
view 0, `dec_blocks2` for the rest), each block self-attending within a
view and cross-attending to all views' tokens through one additive
view-block mask (context views cannot see target views; no view sees
itself).  Per-view intrinsics and learnable pose tokens sit at positions
(gh, 0) and (gh + 1, 0).  `remat` recomputes each transformer block in
the backward pass (activation checkpointing, only while autograd
records), as the JAX config's `remat` does.  The "manyar" patch embed
takes mixed portrait/landscape views (`true_shapes`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.models.croco.layers import (
    Dense,
    EncoderBlock,
    LayerNorm,
    ManyARPatchEmbed,
    Mlp,
    PatchEmbed,
    SelfAttention,
)
from portbench.reference.ops.attention import (
    flash_limits_violation,
    sdpa_view_masked,
)
from portbench.reference.ops.rope import rope_2d


@dataclass(frozen=True)
class CrocoBackboneConfig:
    """ViTLarge_BaseDecoder (the DUSt3R patch embed)."""

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
    pose_token: bool = True
    # "dust3r" (square or landscape views) or "manyar" (mixed portrait and
    # landscape views through `true_shapes`).
    patch_embed_cls: str = "dust3r"
    compute_dtype: str = "bfloat16"
    # Recompute transformer blocks in the backward pass: O(depth) activation
    # memory for the b=16 flagship training batch.
    remat: bool = True

    @property
    def num_extra_tokens(self) -> int:
        return int(self.intrinsics_token) + int(self.pose_token)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def build_cross_view_mask(v: int, num_target: int, view_valid=None,
                          device=None) -> torch.Tensor:
    """(v, v) additive float32 mask: 0 where query view i may attend to
    memory view j, -inf otherwise (diagonal, context -> target, and any
    view marked invalid in `view_valid`)."""
    idx = torch.arange(v, device=device)
    is_target_col = idx[None, :] >= (v - num_target)
    is_context_row = idx[:, None] < (v - num_target)
    blocked = torch.eye(v, dtype=torch.bool, device=device) | (
        is_context_row & is_target_col
    )
    if view_valid is not None:
        blocked = blocked | ~view_valid.to(torch.bool)[None, :]
    return torch.where(blocked, float("-inf"), 0.0).to(torch.float32)


class MultiViewCrossAttention(nn.Module):
    """Cross-attention of a subset of query views over ALL views' tokens."""

    def __init__(self, dim: int, num_heads: int, rope_base: float,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        for name in ("projq", "projk", "projv", "proj"):
            setattr(self, name, Dense(dim, dim, compute_dtype=compute_dtype))
        self.fp8 = False

    def forward(self, q_tokens, mem, qpos, mempos, qview_mask):
        """q_tokens (b, nq, l, c); mem (b, v, l, c); qview_mask (nq, v)."""
        b, nq, l, c = q_tokens.shape
        v = mem.shape[1]
        hd = c // self.num_heads

        def proj(layer, t, n_views):
            y = layer(t)
            return y.reshape(b, n_views * l, self.num_heads, hd).transpose(1, 2)

        q = proj(self.projq, q_tokens, nq)
        k = proj(self.projk, mem, v)
        val = proj(self.projv, mem, v)
        q = rope_2d(q, qpos.reshape(b, nq * l, 2), self.rope_base)
        k = rope_2d(k, mempos.reshape(b, v * l, 2), self.rope_base)
        out = sdpa_view_masked(q, k, val, hd**-0.5, qview_mask, l,
                               fp8=self.fp8)
        out = out.transpose(1, 2).reshape(b, nq, l, c)
        return self.proj(out)


class MultiViewDecoderBlock(nn.Module):
    """Self-attn (within view) + masked cross-attn (across views) + MLP over
    query views [lo, hi) against the full previous-layer token set."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 rope_base: float, lo: int = 0, hi: int | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.lo, self.hi = lo, hi
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, rope_base, compute_dtype)
        self.norm_y = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = MultiViewCrossAttention(dim, num_heads, rope_base,
                                                  compute_dtype)
        self.norm3 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype=compute_dtype)

    def forward(self, x_full, xpos, view_mask):
        b, v, l, c = x_full.shape
        cdt = self.compute_dtype
        hi = v if self.hi is None else self.hi
        x = x_full[:, self.lo: hi]
        qpos = xpos[:, self.lo: hi]
        nq = hi - self.lo
        h = self.norm1(x).to(cdt).reshape(b * nq, l, c)
        x = x + self.attn(h, qpos.reshape(b * nq, l, 2)).reshape(b, nq, l, c)
        mem = self.norm_y(x_full).to(cdt)
        h = self.norm2(x).to(cdt)
        x = x + self.cross_attn(h, mem, qpos, xpos, view_mask[self.lo: hi])
        return x + self.mlp(self.norm3(x).to(cdt))


class MaskedCrocoBackbone(nn.Module):
    def __init__(self, cfg: CrocoBackboneConfig = CrocoBackboneConfig()):
        super().__init__()
        embeds = {"dust3r": PatchEmbed, "manyar": ManyARPatchEmbed}
        if cfg.patch_embed_cls not in embeds:
            raise ValueError(
                f"patch_embed_cls={cfg.patch_embed_cls!r}; options: "
                f"{sorted(embeds)}")
        self.cfg = cfg
        cdt = cfg.dtype
        e, d = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.patch_embed = embeds[cfg.patch_embed_cls](cfg.patch_size, e, cdt)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(e, cfg.enc_num_heads, cfg.mlp_ratio, cfg.rope_base, cdt)
            for _ in range(cfg.enc_depth)
        )
        self.enc_norm = LayerNorm(e)
        if cfg.intrinsics_token:
            self.intrinsic_encoder = Dense(9, e)
        if cfg.pose_token:
            self.pose_token = nn.Parameter(torch.zeros(1, 1, 1, e))
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

    def forward(self, images, intrinsics=None, num_target: int = 0,
                view_valid=None, true_shapes=None):
        """images (b, v, h, w, 3) normalized to [-1, 1]; intrinsics
        (b, v, 3, 3); the trailing `num_target` views are targets;
        `true_shapes` (b, v, 2), each view's real (h, w) for the "manyar"
        embed (portrait views stored transposed; default: as stored).

        Returns {"dec_feat": [(b, v, p, c)] * (dec_depth + 1) float32,
        "pose_feat": [(b, v, 1, c)] or None, "grid": (gh, gw)}.
        """
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        p = gh * gw
        # Each view's self-attention: p keys in the encoder, p plus the
        # intrinsics and pose tokens in the decoders.
        dec_keys = p + cfg.num_extra_tokens
        reason = flash_limits_violation(
            images.device, cfg.dtype,
            [(p, cfg.enc_embed_dim // cfg.enc_num_heads),
             (dec_keys, cfg.dec_embed_dim // cfg.dec_num_heads)])
        if reason is not None:
            raise ValueError(f"{reason}: set CrocoBackboneConfig."
                             f"compute_dtype to 'bfloat16' or 'float32' (it "
                             f"is {cfg.compute_dtype!r}) and keep 64-wide "
                             f"heads, or use smaller images")

        remat = cfg.remat and torch.is_grad_enabled()

        def run(blk, *args):
            if remat:
                return checkpoint(blk, *args, use_reentrant=False)
            return blk(*args)

        flat = images.reshape(b * v, h, w, 3)
        if cfg.patch_embed_cls == "manyar":
            if true_shapes is None:
                true_shapes = torch.tensor([h, w], device=images.device).expand(
                    b, v, 2)
            x, pos = self.patch_embed(flat, true_shapes.reshape(b * v, 2))
        else:
            x, pos = self.patch_embed(flat)
        for blk in self.enc_blocks:
            x = run(blk, x, pos)
        x = self.enc_norm(x)
        x = x.reshape(b, v, p, cfg.enc_embed_dim)
        pos = pos.reshape(b, v, p, 2)

        extra = []
        if cfg.intrinsics_token:
            if intrinsics is None:
                raise ValueError("intrinsics are required by the intrinsics token")
            extra.append(self.intrinsic_encoder(intrinsics.reshape(b, v, 9))[:, :, None])
        if cfg.pose_token:
            extra.append(self.pose_token.expand(b, v, 1, cfg.enc_embed_dim))
        if extra:
            x = torch.cat([x] + extra, dim=2)
            extra_pos = torch.tensor(
                [[gh + i, 0] for i in range(len(extra))], dtype=pos.dtype,
                device=pos.device,
            )
            pos = torch.cat(
                [pos, extra_pos[None, None].expand(b, v, len(extra), 2)], dim=2
            )
        l = x.shape[2]

        view_mask = build_cross_view_mask(v, num_target, view_valid,
                                          device=images.device)
        outputs = [x]
        f = self.decoder_embed(x)
        for blk0, blk_rest in zip(self.dec_blocks, self.dec_blocks2):
            f = torch.cat([run(blk0, f, pos, view_mask),
                           run(blk_rest, f, pos, view_mask)], dim=1)
            outputs.append(f)
        outputs[-1] = self.dec_norm(outputs[-1])

        pose_feat = None
        if cfg.pose_token:
            pose_feat = [o[:, :, l - 1: l].to(torch.float32) for o in outputs]
        dec_feat = [o[:, :, :p].to(torch.float32) for o in outputs]
        return {"dec_feat": dec_feat, "pose_feat": pose_feat, "grid": (gh, gw)}
