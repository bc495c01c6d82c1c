"""VGGT camera head: iterative AdaLN refinement of a 9D pose encoding
(torch port of `spfsplatv2_tpu/models/vggt/camera_head.py`).

The camera tokens (token 0 of the last aggregator layer, 2C wide) are
refined over `num_iterations` steps: each embeds the detached previous
prediction, makes AdaLN shift/scale/gate modulation, runs a float32
transformer trunk across the views' tokens and adds an MLP delta.  The
encoding is [absT (3) | quat xyzw (4) | FoV h, w (2)] of the
world-to-camera transform, ReLU on the FoV terms.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.geometry.se3 import pack_rt, quaternion_to_matrix
from portbench.reference.models.croco.layers import LN_EPS, Dense, LayerNorm
from portbench.reference.models.vggt.layers import VGGTBlock


@dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    num_iterations: int = 4
    target_dim: int = 9


class CameraHead(nn.Module):
    def __init__(self, cfg: CameraHeadConfig = CameraHeadConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim_in
        self.token_norm = LayerNorm(d)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, cfg.target_dim))
        self.embed_pose = Dense(cfg.target_dim, d)
        self.poseLN_modulation = Dense(d, 3 * d)
        self.adaln_norm = nn.LayerNorm(d, eps=LN_EPS, elementwise_affine=False)
        self.trunk = nn.ModuleList(
            VGGTBlock(d, cfg.num_heads, cfg.mlp_ratio, qk_norm=False,
                      init_values=cfg.init_values, rope_base=None,
                      compute_dtype=torch.float32)
            for _ in range(cfg.trunk_depth)
        )
        self.trunk_norm = LayerNorm(d)
        self.pose_branch_fc1 = Dense(d, d // 2)
        self.pose_branch_fc2 = Dense(d // 2, cfg.target_dim)

    def forward(self, camera_tokens, view_valid=None):
        """camera_tokens (b, v, c) float32 -> activated pose encoding
        (b, v, 9).  `view_valid` ((v,), optional) blocks a dropped view's
        token as a key for every query, as if the view were sliced out;
        each row still sees its own or another valid view."""
        cfg = self.cfg
        b, v, _ = camera_tokens.shape
        attn_mask = None
        if view_valid is not None:
            col = torch.where(view_valid.to(torch.bool), 0.0, float("-inf"))
            attn_mask = col.to(torch.float32)[None, :].expand(v, v)
        tokens = self.token_norm(camera_tokens)

        pred = None
        for _ in range(cfg.num_iterations):
            if pred is None:
                module_input = self.embed_pose(
                    self.empty_pose_tokens.expand(b, v, cfg.target_dim))
            else:
                module_input = self.embed_pose(pred.detach())
            shift, scale, gate = self.poseLN_modulation(
                F.silu(module_input)).chunk(3, dim=-1)
            x = gate * (self.adaln_norm(tokens) * (1 + scale) + shift) + tokens
            for blk in self.trunk:
                x = blk(x, mask=attn_mask)
            delta = self.pose_branch_fc2(F.gelu(
                self.pose_branch_fc1(self.trunk_norm(x)), approximate="none"))
            pred = delta if pred is None else pred + delta
        return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], dim=-1)


def pose_encoding_to_w2c(enc: torch.Tensor) -> torch.Tensor:
    """[absT | quat xyzw | fov] -> (..., 4, 4) world-to-camera matrix
    (the quaternion is scalar-last)."""
    quat_wxyz = torch.cat([enc[..., 6:7], enc[..., 3:6]], dim=-1)
    return pack_rt(quaternion_to_matrix(quat_wxyz), enc[..., :3])


def fov_to_intrinsics(enc: torch.Tensor) -> torch.Tensor:
    """FoV terms -> normalized intrinsics, principal point centred."""
    fy = 0.5 / torch.tan(enc[..., 7] / 2.0)
    fx = 0.5 / torch.tan(enc[..., 8] / 2.0)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    rows = torch.stack([fx, zeros, 0.5 * ones, zeros, fy, 0.5 * ones,
                        zeros, zeros, ones], dim=-1)
    return rows.reshape(*enc.shape[:-1], 3, 3)
