"""Seeded random state dicts in the MASt3R / DUSt3R checkpoint layout.

The published checkpoints are not in the repository, so the converters
of `utils/ckpt_convert.py` are exercised (and `chip_smoke.py` loads its
full-width student and teacher) on state dicts with their key names and
shapes and seeded random values:

    sd = reference_state_dict(seed=0)                  # DUSt3R, full width
    sd = reference_state_dict(seed=0, mast3r=True)     # + MASt3R's heads
    sd = reference_state_dict(seed=0, enc_depth=2, enc_dim=64,
                              dec_depth=2, dec_dim=48)  # tiny
"""

from __future__ import annotations

import math

import torch

# MASt3R's local-feature head (ignored by the converters): an MLP from the
# concatenated encoder and decoder tokens to 24 descriptor channels and a
# confidence per pixel of a patch.
MAST3R_LOCAL_FEAT_DIM = 24


def reference_key_shapes(enc_depth: int = 24, enc_dim: int = 1024,
                         dec_depth: int = 12, dec_dim: int = 768,
                         patch: int = 16, head_channels: int = 4,
                         layer_dims: tuple[int, ...] = (96, 192, 384, 768),
                         feature_dim: int = 256, last_dim: int = 128
                         ) -> dict[str, tuple[int, ...]]:
    """Key -> shape of a DUSt3R checkpoint's weights (the CroCo trunk with
    both decoders and two DPT heads of `head_channels` outputs): the
    layout the converters of `utils/ckpt_convert.py` read."""
    shapes: dict[str, tuple[int, ...]] = {}

    def linear(name, n_in, n_out):
        shapes[f"{name}.weight"] = (n_out, n_in)
        shapes[f"{name}.bias"] = (n_out,)

    def conv(name, n_in, n_out, k, bias=True, transposed=False):
        shapes[f"{name}.weight"] = ((n_in, n_out) if transposed
                                    else (n_out, n_in)) + (k, k)
        if bias:
            shapes[f"{name}.bias"] = (n_out,)

    def norm(name, dim):
        shapes[f"{name}.weight"] = shapes[f"{name}.bias"] = (dim,)

    def block(p, dim, cross):
        norm(f"{p}.norm1", dim)
        linear(f"{p}.attn.qkv", dim, 3 * dim)
        linear(f"{p}.attn.proj", dim, dim)
        norm(f"{p}.norm2", dim)
        linear(f"{p}.mlp.fc1", dim, 4 * dim)
        linear(f"{p}.mlp.fc2", 4 * dim, dim)
        if cross:
            norm(f"{p}.norm3", dim)
            norm(f"{p}.norm_y", dim)
            for name in ("projq", "projk", "projv", "proj"):
                linear(f"{p}.cross_attn.{name}", dim, dim)

    conv("patch_embed.proj", 3, enc_dim, patch)
    for i in range(enc_depth):
        block(f"enc_blocks.{i}", enc_dim, cross=False)
    norm("enc_norm", enc_dim)
    linear("decoder_embed", enc_dim, dec_dim)
    for i in range(dec_depth):
        block(f"dec_blocks.{i}", dec_dim, cross=True)
        block(f"dec_blocks2.{i}", dec_dim, cross=True)
    norm("dec_norm", dec_dim)
    ld = layer_dims
    for n in (1, 2):
        p = f"downstream_head{n}.dpt"
        conv(f"{p}.act_postprocess.0.0", enc_dim, ld[0], 1)
        conv(f"{p}.act_postprocess.0.1", ld[0], ld[0], 4, transposed=True)
        conv(f"{p}.act_postprocess.1.0", dec_dim, ld[1], 1)
        conv(f"{p}.act_postprocess.1.1", ld[1], ld[1], 2, transposed=True)
        conv(f"{p}.act_postprocess.2.0", dec_dim, ld[2], 1)
        conv(f"{p}.act_postprocess.3.0", dec_dim, ld[3], 1)
        conv(f"{p}.act_postprocess.3.1", ld[3], ld[3], 3)
        for i in range(1, 5):
            conv(f"{p}.scratch.layer{i}_rn", ld[i - 1], feature_dim, 3,
                 bias=False)
            rp = f"{p}.scratch.refinenet{i}"
            conv(f"{rp}.out_conv", feature_dim, feature_dim, 1)
            for unit in ("resConfUnit1", "resConfUnit2"):
                for c in ("conv1", "conv2"):
                    conv(f"{rp}.{unit}.{c}", feature_dim, feature_dim, 3)
        conv(f"{p}.head.0", feature_dim, feature_dim // 2, 3)
        conv(f"{p}.head.2", feature_dim // 2, last_dim, 3)
        conv(f"{p}.head.4", last_dim, head_channels, 1)
    return shapes


def reference_state_dict(seed: int, enc_depth: int = 24, enc_dim: int = 1024,
                         dec_depth: int = 12, dec_dim: int = 768,
                         patch: int = 16, mast3r: bool = False,
                         device: str | torch.device = "cpu",
                         **head_dims) -> dict[str, torch.Tensor]:
    """A state dict with `reference_key_shapes`' keys (and with `mast3r`
    also MASt3R's local-feature heads, which the converters ignore),
    drawn on `device` from a generator seeded with `seed`: LayerNorm
    weights near 1, biases near 0, LeCun-scaled kernels, and the DPT
    heads' output layer at a tenth of that, near the calibrated init.  A
    confidence channel's bias sits near log 2, so that DUSt3R's
    confidence 1 + exp(x) straddles the bar of 3 that distillation
    applies (`losses/point.py`)."""
    shapes = reference_key_shapes(enc_depth, enc_dim, dec_depth, dec_dim,
                                  patch, **head_dims)
    if mast3r:
        width = enc_dim + dec_dim
        local = {"fc1": (4 * width, width),
                 "fc2": ((MAST3R_LOCAL_FEAT_DIM + 1) * patch ** 2, 4 * width)}
        for n in (1, 2):
            for name, shape in local.items():
                base = f"downstream_head{n}.head_local_features.{name}"
                shapes[f"{base}.weight"] = shape
                shapes[f"{base}.bias"] = shape[:1]
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device)
        if key.endswith(".bias"):
            x = 0.05 * x
        elif len(shape) == 1:           # LayerNorm weights
            x = 1.0 + 0.1 * x
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
            if ".head.4." in key:
                x = 0.1 * x
        if key.endswith(".head.4.bias") and shape[0] == 4:
            x[3] += math.log(2.0)
        sd[key] = x
    return sd
