"""VGGT DPT heads, point map and Gaussian parameters, over aggregator
tokens (torch port of `spfsplatv2_tpu/models/vggt/dpt_head.py`).

Unlike the CroCo-side DPT (`models/heads/dpt.py`): a LayerNorm on the
hooked 2C-wide tokens, per-hook widths (256, 512, 1024, 1024),
refinenet4 without a skip input, sinusoidal uv-grid embeddings (ratio
0.1) added to the pyramid maps and to the full-resolution map, fusion to
the next level's exact size, and an upsample to patch_size x grid before
the output convs.  The GS variant adds a Conv7x7(3 -> 128) RGB skip
(`input_merger`) and returns the raw output.  The interface is NHWC; the
convolutions run channels-first in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models.croco.layers import LayerNorm
from portbench.reference.utils.cudnn import without_cudnn
from portbench.reference.utils.interp import resize_bilinear_nchw


class VGGTResidualConvUnit(nn.Module):
    """The skip adds relu(x), not x: the reference passes an in-place ReLU
    as the activation, which overwrites the residual, and the released
    VGGT-1B weights were trained so.  Kept deliberately."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        h = F.relu(x)
        return self.conv2(F.relu(self.conv1(h))) + h


class VGGTFeatureFusionBlock(nn.Module):
    """Residual unit on the skip input (when there is one), refinement,
    align-corners bilinear resize to `out_hw` (default 2x), 1x1 conv."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = VGGTResidualConvUnit(features)
        self.resConfUnit2 = VGGTResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if out_hw is None:
            out_hw = (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(resize_bilinear_nchw(x, out_hw))


HOOK_FRACTIONS = (4 / 23, 11 / 23, 17 / 23, 1.0)


def vggt_hooks(n_layers: int) -> tuple[int, ...]:
    """Layers (4, 11, 17, 23) at depth 24, scaled for other depths."""
    return tuple(round(f * (n_layers - 1)) for f in HOOK_FRACTIONS)


def uv_pos_embed(gh: int, gw: int, channels: int, aspect: float,
                 device=None) -> torch.Tensor:
    """(gh, gw, channels) sinusoidal embedding of a normalized uv grid,
    omega_0 = 100; the caller applies the ratio."""
    diag = (aspect**2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (gw - 1) / gw, span_x * (gw - 1) / gw, gw,
                        device=device)
    ys = torch.linspace(-span_y * (gh - 1) / gh, span_y * (gh - 1) / gh, gh,
                        device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")

    def sincos(pos, dim):
        omega = torch.arange(dim // 2, dtype=torch.float32, device=device)
        omega = 1.0 / (100.0 ** (omega / (dim / 2.0)))
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    emb = torch.cat([sincos(uu, channels // 2), sincos(vv, channels // 2)],
                    dim=-1)
    return emb.reshape(gh, gw, channels)


class VGGTDPTHead(nn.Module):
    """Point-map / Gaussian-parameter DPT head on (b, v, p, dim_in) tokens."""

    def __init__(self, dim_in: int, output_dim: int = 4, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14, pos_embed: bool = True,
                 gs_variant: bool = False,
                 hooks: Sequence[int] | None = None):
        super().__init__()
        self.output_dim = output_dim
        self.out_channels = tuple(out_channels)
        self.patch_size = patch_size
        self.pos_embed = pos_embed
        self.gs_variant = gs_variant
        self.hooks = hooks
        oc = self.out_channels
        self.norm = LayerNorm(dim_in)
        for i, ch in enumerate(oc):
            setattr(self, f"projects_{i}", nn.Conv2d(dim_in, ch, 1))
        self.resize_0 = nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)
        for i, ch in enumerate(oc):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, features, 3, padding=1, bias=False))
        self.refinenet4 = VGGTFeatureFusionBlock(features, has_skip=False)
        self.refinenet3 = VGGTFeatureFusionBlock(features)
        self.refinenet2 = VGGTFeatureFusionBlock(features)
        self.refinenet1 = VGGTFeatureFusionBlock(features)
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        if gs_variant:
            self.input_merger = nn.Conv2d(3, 128, 7, padding=3)
        self.output_conv2_0 = nn.Conv2d(features // 2, 32, 3, padding=1)
        self.output_conv2_2 = nn.Conv2d(32, output_dim, 1)

    def _add_uv(self, x, aspect):
        """x (n, c, h, w) + 0.1 x the uv embedding of its grid."""
        emb = uv_pos_embed(x.shape[2], x.shape[3], x.shape[1], aspect,
                           x.device)
        return x + emb.permute(2, 0, 1) * 0.1

    def forward(self, tokens_list, grid, patch_start: int, images=None):
        """tokens_list: each layer's (b, v, p_total, dim_in); images
        (b, v, h, w, 3), required by the GS variant.  Returns (b, v, H, W,
        output_dim) for the GS variant, else the points (b, v, H, W, 3)
        and their confidence (b, v, H, W)."""
        gh, gw = grid
        b, v = tokens_list[0].shape[:2]
        h_out, w_out = gh * self.patch_size, gw * self.patch_size
        aspect = w_out / h_out

        pyramid = []
        hooks = self.hooks or vggt_hooks(len(tokens_list))
        for i, hook in enumerate(hooks):
            x = self.norm(tokens_list[hook][:, :, patch_start:])
            x = x.reshape(b * v, gh, gw, -1).permute(0, 3, 1, 2)
            x = getattr(self, f"projects_{i}")(x)
            if self.pos_embed:
                x = self._add_uv(x, aspect)
            if i == 0:
                x = self.resize_0(x)
            elif i == 1:
                x = self.resize_1(x)
            elif i == 3:
                x = self.resize_3(x)
            pyramid.append(x)

        rn = [getattr(self, f"layer{i + 1}_rn")(p) for i, p in enumerate(pyramid)]
        # Fusion resizes to the next pyramid level's exact size.
        path = self.refinenet4(rn[3], out_hw=rn[2].shape[2:])
        path = self.refinenet3(path, rn[2], out_hw=rn[1].shape[2:])
        path = self.refinenet2(path, rn[1], out_hw=rn[0].shape[2:])
        path = self.refinenet1(path, rn[0])

        # cuDNN's float32 forward (TF32 off) for this convolution, 256 -> 128
        # channels 3x3 on 2 or more maps of 128^2, takes an FFT algorithm:
        # 443 ms and a 17.6 GB workspace for 2 maps, where PyTorch's own
        # im2col + GEMM takes 0.68 ms (H100, cuDNN 9.2; `chip_smoke.py`
        # phase "vggt_serve", "conv_probe").  Only the forward is
        # switched; the backward keeps cuDNN.
        out = without_cudnn(self.output_conv1, path)
        out = resize_bilinear_nchw(out, (h_out, w_out))
        if self.gs_variant:
            if images is None:
                raise ValueError("the GS head needs the images")
            rgb = images.reshape(b * v, h_out, w_out, 3).permute(0, 3, 1, 2)
            out = out + F.relu(self.input_merger(rgb))
        if self.pos_embed:
            out = self._add_uv(out, aspect)
        out = self.output_conv2_2(F.relu(self.output_conv2_0(out)))
        out = out.permute(0, 2, 3, 1).reshape(b, v, h_out, w_out,
                                              self.output_dim)
        if self.gs_variant:
            return out
        # Point head: inverse-log xyz, 1 + exp confidence.
        xyz, conf = out[..., :-1], out[..., -1]
        return torch.sign(xyz) * torch.expm1(torch.abs(xyz)), 1.0 + torch.exp(conf)
