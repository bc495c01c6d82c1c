"""VGGT/DINOv2-style transformer layers (torch port of
`spfsplatv2_tpu/models/vggt/layers.py`).

Pre-norm blocks with optional per-head-dim QK LayerNorm, LayerScale
residual scaling, RoPE on the tokens' (y, x) positions, and three
attention branches: `sdpa` without a mask (frame attention, DINOv2), the
view-masked attention for a `(view_mask, tokens_per_view)` tuple (global
attention) and a dense additive mask otherwise (the camera head's trunk
under view dropout).  Dense layers compute in `compute_dtype`,
LayerNorms in float32 with eps 1e-6, GELU in its exact form; names
follow the flax modules for `utils/from_flax.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models.croco.layers import Dense, LayerNorm
from portbench.reference.ops.attention import sdpa, sdpa_view_masked
from portbench.reference.ops.rope import rope_2d


class VGGTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool = True,
                 rope_base: float | None = 100.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.compute_dtype = compute_dtype
        self.qkv = Dense(dim, 3 * dim, compute_dtype=compute_dtype)
        if qk_norm:
            self.q_norm = LayerNorm(dim // num_heads)
            self.k_norm = LayerNorm(dim // num_heads)
        self.qk_norm = qk_norm
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)
        self.fp8 = False

    def forward(self, x, pos=None, mask=None):
        """x (b, n, c); pos (b, n, 2) or None; mask None, a (view_mask,
        tokens_per_view) tuple or an additive (..., n, n) tensor."""
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)    # each (b, h, n, d)
        if self.qk_norm:
            q = self.q_norm(q).to(self.compute_dtype)
            k = self.k_norm(k).to(self.compute_dtype)
        if self.rope_base is not None and pos is not None:
            q = rope_2d(q, pos, self.rope_base)
            k = rope_2d(k, pos, self.rope_base)
        if mask is None:
            out = sdpa(q, k, v, hd**-0.5, fp8=self.fp8)
        elif isinstance(mask, tuple):
            view_mask, tokens_per_view = mask
            out = sdpa_view_masked(q, k, v, hd**-0.5, view_mask,
                                   tokens_per_view, fp8=self.fp8)
        else:
            logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
            probs = torch.softmax(logits * hd**-0.5 + mask, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma


class VGGTBlock(nn.Module):
    """Pre-norm attention + MLP with LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qk_norm: bool = True, init_values: float | None = 0.01,
                 rope_base: float | None = 100.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.attn = VGGTAttention(dim, num_heads, qk_norm, rope_base,
                                  compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, hidden, compute_dtype=compute_dtype)
        self.mlp_fc2 = Dense(hidden, dim, compute_dtype=compute_dtype)
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        self.layer_scale = init_values is not None

    def forward(self, x, pos=None, mask=None):
        cdt = self.compute_dtype
        attn = self.attn(self.norm1(x).to(cdt), pos, mask)
        if self.layer_scale:
            attn = self.ls1(attn)
        x = x + attn
        y = F.gelu(self.mlp_fc1(self.norm2(x).to(cdt)), approximate="none")
        y = self.mlp_fc2(y)
        if self.layer_scale:
            y = self.ls2(y)
        return x + y
