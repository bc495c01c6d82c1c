"""MLP pose head: pose token -> 9D pose encoding [6D rot | t] (torch port
of `spfsplatv2_tpu/models/heads/pose_head.py`)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models.croco.layers import Dense


@dataclass(frozen=True)
class PoseHeadConfig:
    init_t: bool = True
    use_homogeneous: bool = False
    # Read by the v1 encoder's config only (pooled encoder + decoder
    # tokens); this head takes the pose token either way.
    concat_enc: bool = False
    min_scale: float = 0.01
    max_scale: float = 4.0


class PoseHead(nn.Module):
    def __init__(self, dim: int, cfg: PoseHeadConfig = PoseHeadConfig()):
        super().__init__()
        self.cfg = cfg
        self.mlp1 = Dense(dim, dim // 2)
        self.mlp2 = Dense(dim // 2, dim // 4)
        self.fc_t = Dense(dim // 4, 4 if cfg.use_homogeneous else 3)
        self.fc_rot = Dense(dim // 4, 6)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (b, n, c), pooled over n -> (b, 9)."""
        feat = F.relu(self.mlp2(F.relu(self.mlp1(tokens.mean(dim=1)))))
        out_t = self.fc_t(feat)
        if self.cfg.use_homogeneous:
            max_inv = 1.0 / self.cfg.max_scale
            min_inv = 1.0 / self.cfg.min_scale
            beta = math.log(2.0) / (1.0 - max_inv)
            h = F.softplus(beta * out_t[:, 3:4]) / beta + max_inv
            out_t = out_t[:, :3] / torch.clamp(h, max=min_inv)
        return torch.cat([self.fc_rot(feat), out_t], dim=-1)
