"""The lower precisions of the benchmark's control.

The control is the reference computed one step below the precision that a
configuration states: its bfloat16 parts (`bf16_parts` in the config
file) with every Dense, Conv and attention product taken in float8, as an
fp8 training recipe takes them (operands in e4m3 under a per-tensor
scale, the gradients that come back to each product in e5m2, float32
sums), and its float32 parts in TF32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3, E4M3_MAX = torch.float8_e4m3fn, 448.0
E5M2, E5M2_MAX = torch.float8_e5m2, 57344.0


def _round(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """`t` rounded to a float8 format under a per-tensor scale (its amax to
    the format's largest), back in its dtype."""
    amax = t.detach().abs().amax().to(torch.float32).clamp(min=1e-30)
    scale = fmax / amax
    q = (t.detach().to(torch.float32) * scale).to(dtype)
    return (q.to(torch.float32) / scale).to(t.dtype)


class _Operand(torch.autograd.Function):
    """A GEMM operand in e4m3; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, E4M3, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradE5M2(torch.autograd.Function):
    """A GEMM's output as it is; the gradient that comes back to it in e5m2
    (the operand of both backward GEMMs)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, E5M2, E5M2_MAX)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return _Operand.apply(t)


def fp8_grad(t: torch.Tensor) -> torch.Tensor:
    return _GradE5M2.apply(t)


def set_fp8(model: torch.nn.Module, parts) -> int:
    """Turn the float8 rounding on in every Dense, Conv and attention under
    the named top-level submodules; returns how many."""
    n = 0
    for name, mod in model.named_modules():
        if hasattr(mod, "fp8") and name.split(".")[0] in parts:
            mod.fp8 = True
            n += 1
    return n


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on (or off) for float32 matmuls and cuDNN convolutions inside
    the block; the previous flags come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
