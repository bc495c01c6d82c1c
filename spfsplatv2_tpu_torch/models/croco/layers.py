"""CroCo/DUSt3R ViT building blocks (torch port of
`spfsplatv2_tpu/models/croco/layers.py`).

Module and parameter names follow the flax modules (`qkv`, `proj`,
`norm1`, `fc1`, ...), so that `utils/from_flax.py` maps a flax param tree
mechanically.  The JAX blocks compute dense layers in `compute_dtype`
(bfloat16 by default) with float32 params, and LayerNorms in float32
with eps 1e-6; the port reproduces that with explicit casts (`Dense`,
`Conv`, `LayerNorm` below), not autocast, so a float32 config compares
like with like.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spfsplatv2_tpu_torch.ops.attention import sdpa
from spfsplatv2_tpu_torch.ops.rope import rope_2d

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=compute_dtype)`: input, weight and bias cast to
    `compute_dtype`; None computes in the promoted dtype (float32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv(nn.Conv2d):
    """flax `nn.Conv(dtype=compute_dtype)` on NCHW tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=float32)`: float32 statistics and output."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), self.normalized_shape,
                            self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, compute_dtype=compute_dtype)
        self.fc2 = Dense(hidden_dim, out_dim or in_dim,
                         compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def _split_heads(y, b, num_heads):
    """(b, n, c) -> (b, heads, n, head_dim)."""
    return y.reshape(b, -1, num_heads, y.shape[-1] // num_heads).transpose(1, 2)


class SelfAttention(nn.Module):
    """RoPE self-attention."""

    def __init__(self, dim: int, num_heads: int, rope_base: float | None = 100.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = Dense(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x, xpos):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)   # each (b, h, n, d)
        if self.rope_base is not None:
            q = rope_2d(q, xpos, self.rope_base)
            k = rope_2d(k, xpos, self.rope_base)
        out = sdpa(q, k, v, hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class CrossAttention(nn.Module):
    """RoPE cross-attention."""

    def __init__(self, dim: int, num_heads: int, rope_base: float | None = 100.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        for name in ("projq", "projk", "projv", "proj"):
            setattr(self, name, Dense(dim, dim, compute_dtype=compute_dtype))

    def forward(self, query, key, value, qpos, kpos):
        b, nq, c = query.shape
        hd = c // self.num_heads
        q = _split_heads(self.projq(query), b, self.num_heads)
        k = _split_heads(self.projk(key), b, self.num_heads)
        v = _split_heads(self.projv(value), b, self.num_heads)
        if self.rope_base is not None:
            q = rope_2d(q, qpos, self.rope_base)
            k = rope_2d(k, kpos, self.rope_base)
        out = sdpa(q, k, v, hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, nq, c))


class EncoderBlock(nn.Module):
    """Pre-norm ViT block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: float | None = 100.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, rope_base, compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype=compute_dtype)

    def forward(self, x, xpos):
        cdt = self.compute_dtype
        x = x + self.attn(self.norm1(x).to(cdt), xpos)
        return x + self.mlp(self.norm2(x).to(cdt))


class DecoderBlock(nn.Module):
    """Self-attn -> cross-attn -> MLP block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 rope_base: float | None = 100.0, norm_mem: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, rope_base, compute_dtype)
        self.norm_y = LayerNorm(dim) if norm_mem else None
        self.norm2 = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, rope_base, compute_dtype)
        self.norm3 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype=compute_dtype)

    def forward(self, x, memory, xpos, mempos):
        cdt = self.compute_dtype
        x = x + self.attn(self.norm1(x).to(cdt), xpos)
        mem = self.norm_y(memory) if self.norm_y is not None else memory
        mem = mem.to(cdt)
        x = x + self.cross_attn(self.norm2(x).to(cdt), mem, mem, xpos, mempos)
        return x + self.mlp(self.norm3(x).to(cdt))


class PatchEmbed(nn.Module):
    """Conv patch embed + integer (y, x) positions."""

    def __init__(self, patch_size: int, embed_dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16, in_ch: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv(in_ch, embed_dim, patch_size, stride=patch_size,
                         compute_dtype=compute_dtype)

    def forward(self, images):
        """images (b, h, w, 3) -> tokens (b, n, c), positions (b, n, 2)."""
        b, h, w, _ = images.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by {p}")
        x = self.proj(images.permute(0, 3, 1, 2))          # (b, c, gh, gw)
        x = x.flatten(2).transpose(1, 2)                    # (b, gh*gw, c)
        gh, gw = h // p, w // p
        yy, xx = torch.meshgrid(
            torch.arange(gh, dtype=torch.int32, device=images.device),
            torch.arange(gw, dtype=torch.int32, device=images.device),
            indexing="ij",
        )
        pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
        return x, pos[None].expand(b, gh * gw, 2)


class ManyARPatchEmbed(PatchEmbed):
    """Mixed portrait/landscape patch embed (ManyAR).

    Every image is stored landscape (w >= h buffer); `true_shapes` (b, 2)
    gives each image's real (height, width).  A portrait image is embedded
    from the transposed buffer with transposed (y, x) positions.  Both
    orientations go through the shared conv and each image selects its
    own, so every portrait/landscape mix runs the same program.
    """

    def forward(self, images, true_shapes):
        """(b, h, w, 3) landscape buffers + (b, 2) true (h, w) -> tokens
        (b, n, c), positions (b, n, 2)."""
        b, h, w, _ = images.shape
        if w < h:
            raise ValueError(f"ManyAR buffers must be landscape, got {h}x{w}")
        x_land, pos_land = super().forward(images)
        x_port, pos_port = super().forward(images.transpose(1, 2))
        landscape = (true_shapes[:, 1] >= true_shapes[:, 0])[:, None, None]
        return (torch.where(landscape, x_land, x_port),
                torch.where(landscape, pos_land, pos_port))
