"""DPT prediction heads, pointmap and Gaussian-parameter variants (torch
port of `spfsplatv2_tpu/models/heads/dpt.py`).

The public interface keeps the JAX layout: token lists (b, p, c) in,
NHWC maps out.  Inside, the convolutions run channels-first.  All heads
compute in float32.  The calibrated init of the output layers lives in
`models/encoder.py:SPFSplatV2Encoder.init_weights`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from spfsplatv2_tpu_torch.utils.interp import resize_bilinear_nchw


class ResidualConvUnit(nn.Module):
    """ReLU-Conv3-ReLU-Conv3 with skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def _upsample2x(x):
    return resize_bilinear_nchw(x, (2 * x.shape[-2], 2 * x.shape[-1]))


class FeatureFusionBlock(nn.Module):
    """RefineNet-style fusion; `resConfUnit1` exists only with a skip input
    (the flax module creates it only when called with one)."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(_upsample2x(x))


class DPTCore(nn.Module):
    """Token pyramid -> fused feature map at 8x the patch grid (NCHW)."""

    def __init__(self, in_dims: Sequence[int],
                 layer_dims: Sequence[int] = (96, 192, 384, 768),
                 feature_dim: int = 256):
        super().__init__()
        ld = layer_dims
        self.act_0_proj = nn.Conv2d(in_dims[0], ld[0], 1)
        self.act_0_up = nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)
        self.act_1_proj = nn.Conv2d(in_dims[1], ld[1], 1)
        self.act_1_up = nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)
        self.act_2_proj = nn.Conv2d(in_dims[2], ld[2], 1)
        self.act_3_proj = nn.Conv2d(in_dims[3], ld[3], 1)
        self.act_3_down = nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ld[i], feature_dim, 3, padding=1, bias=False))
        self.refinenet4 = FeatureFusionBlock(feature_dim, has_skip=False)
        self.refinenet3 = FeatureFusionBlock(feature_dim)
        self.refinenet2 = FeatureFusionBlock(feature_dim)
        self.refinenet1 = FeatureFusionBlock(feature_dim)

    def forward(self, hooked_tokens, grid):
        gh, gw = grid
        maps = [t.transpose(1, 2).reshape(t.shape[0], t.shape[-1], gh, gw)
                for t in hooked_tokens]
        l0 = self.act_0_up(self.act_0_proj(maps[0]))
        l1 = self.act_1_up(self.act_1_proj(maps[1]))
        l2 = self.act_2_proj(maps[2])
        l3 = self.act_3_down(self.act_3_proj(maps[3]))
        rn = [self.layer1_rn(l0), self.layer2_rn(l1), self.layer3_rn(l2),
              self.layer4_rn(l3)]
        path4 = self.refinenet4(rn[3])
        path4 = path4[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        path3 = self.refinenet3(path4, rn[2])
        path2 = self.refinenet2(path3, rn[1])
        return self.refinenet1(path2, rn[0])


class DPTHead(nn.Module):
    """Regression DPT head (pointmaps) at full resolution."""

    def __init__(self, in_dims: Sequence[int], out_channels: int = 3,
                 feature_dim: int = 256, last_dim: int = 128,
                 layer_dims: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        self.core = DPTCore(in_dims, layer_dims, feature_dim)
        self.head_conv1 = nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1)
        self.head_conv2 = nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1)
        self.head_out = nn.Conv2d(last_dim, out_channels, 1)

    def forward(self, hooked_tokens, grid):
        """-> (b, h, w, out_channels)."""
        x = self.head_conv1(self.core(hooked_tokens, grid))
        x = F.relu(self.head_conv2(_upsample2x(x)))
        return self.head_out(x).permute(0, 2, 3, 1)


class DPTGSHead(nn.Module):
    """Gaussian-parameter DPT head with the full-resolution RGB skip."""

    def __init__(self, in_dims: Sequence[int], out_channels: int,
                 feature_dim: int = 256,
                 layer_dims: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        self.core = DPTCore(in_dims, layer_dims, feature_dim)
        self.input_merger = nn.Conv2d(3, feature_dim, 7, padding=3)
        self.head_conv = nn.Conv2d(feature_dim, feature_dim, 3, padding=1,
                                   bias=False)
        self.head_out = nn.Conv2d(feature_dim, out_channels, 1)

    def forward(self, hooked_tokens, grid, image):
        """image (b, h, w, 3) normalized input -> (b, h, w, out_channels)."""
        x = _upsample2x(self.core(hooked_tokens, grid))
        x = x + F.relu(self.input_merger(image.permute(0, 3, 1, 2)))
        x = F.relu(self.head_conv(x))
        return self.head_out(x).permute(0, 2, 3, 1)
