"""2D rotary position embeddings, RoPE2D (torch port of
`spfsplatv2_tpu/ops/rope.py`): the head dim is split into a y-half and an
x-half, each rotated by a 1D RoPE on the integer (y, x) token position in
the rotate-half layout.  cos/sin are computed in float32 and cast to the
tokens' dtype, as the JAX function does."""

from __future__ import annotations

import torch


def _rope_1d(tokens: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """tokens (..., n, d) with d even; pos (..., n) integer positions."""
    d = tokens.shape[-1]
    half = d // 2
    inv_freq = 1.0 / (base ** (
        torch.arange(0, half, dtype=torch.float32, device=tokens.device) / half
    ))
    ang = pos[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(ang).to(tokens.dtype)
    sin = torch.sin(ang).to(tokens.dtype)
    cos = torch.cat([cos, cos], dim=-1)
    sin = torch.cat([sin, sin], dim=-1)
    x1, x2 = tokens[..., :half], tokens[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return tokens * cos + rotated * sin


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor,
            base: float = 100.0) -> torch.Tensor:
    """tokens (b, heads, n, d) with d % 4 == 0; positions (b, n, 2) (y, x)."""
    d = tokens.shape[-1]
    if d % 4:
        raise ValueError("RoPE2D needs head_dim divisible by 4")
    y_tok, x_tok = tokens[..., : d // 2], tokens[..., d // 2:]
    y_pos = positions[..., None, :, 0]
    x_pos = positions[..., None, :, 1]
    return torch.cat(
        [_rope_1d(y_tok, y_pos, base), _rope_1d(x_tok, x_pos, base)], dim=-1
    )
