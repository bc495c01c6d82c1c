"""A reference VGGT-1B / SPFSplatV2-L state dict -> the port's
`SPFSplatV2LEncoder` state dict (torch port of
`spfsplatv2_tpu/utils/ckpt_convert_vggt.py`).

Maps the vendored Meta module names onto the port's, which follow the
flax modules:

  reference                                port
  aggregator.patch_embed.* (DINOv2)     -> aggregator.patch_embed.*
    .patch_embed.proj.*                 ->   .patch_embed.*
    .blocks.{i}.mlp.fc1.*               ->   .blocks.{i}.mlp_fc1.*
  aggregator.{frame,global}_blocks.{i}.* -> the same, mlp.fc* -> mlp_fc*
  aggregator.camera_token (1, 2, 1, C)  -> aggregator.camera_token (2, 1, C)
  aggregator.register_token (1, 2, R, C) -> aggregator.register_token (2, R, C)
  camera_head.poseLN_modulation.1.*     -> camera_head.poseLN_modulation.*
  camera_head.pose_branch.fc{1,2}.*     -> camera_head.pose_branch_fc{1,2}.*
  {point,gaussian_param}_head.projects.{i}.*      -> .projects_{i}.*
    .resize_layers.{i}.*                -> .resize_{i}.*
    .scratch.{layer*_rn,refinenet*,output_conv1}.* -> without "scratch."
    .scratch.output_conv2.{i}.*         -> .output_conv2_{i}.*
    .input_merger.0.*                   -> .input_merger.*

Both sides are torch layouts, so the weights move unchanged.  The JAX
converter reads exactly these keys and so does this one: `track_head.*`,
`depth_head.*` and any other key (DINOv2's `mask_token`) are dropped, as
the reference never instantiates them for SPFSplatV2-L.  Nothing here
reads a file: load the checkpoint with `torch.load` and pass its dict.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


class _Out:
    """Collects port keys from reference keys."""

    def __init__(self, sd: Mapping):
        self.sd = sd
        self.out: dict[str, torch.Tensor] = {}

    def has(self, key: str) -> bool:
        return key in self.sd

    def put(self, dst: str, src: str, leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            v = self.sd[f"{src}.{leaf}"]
            self.out[f"{dst}.{leaf}"] = (v if torch.is_tensor(v)
                                         else torch.from_numpy(np.array(v)))

    def put_tensor(self, dst: str, value) -> None:
        self.out[dst] = (value if torch.is_tensor(value)
                         else torch.from_numpy(np.array(value)))


def _vggt_block(o: _Out, src: str, dst: str, qk_norm: bool) -> None:
    for name in ("norm1", "attn.qkv", "attn.proj", "norm2"):
        o.put(f"{dst}.{name}", f"{src}.{name}")
    o.put(f"{dst}.mlp_fc1", f"{src}.mlp.fc1")
    o.put(f"{dst}.mlp_fc2", f"{src}.mlp.fc2")
    if qk_norm and o.has(f"{src}.attn.q_norm.weight"):
        o.put(f"{dst}.attn.q_norm", f"{src}.attn.q_norm")
        o.put(f"{dst}.attn.k_norm", f"{src}.attn.k_norm")
    if o.has(f"{src}.ls1.gamma"):
        o.put(f"{dst}.ls1", f"{src}.ls1", ("gamma",))
        o.put(f"{dst}.ls2", f"{src}.ls2", ("gamma",))


def _dinov2(o: _Out, p: str, depth: int) -> None:
    o.put(f"{p}.patch_embed", f"{p}.patch_embed.proj")
    for name in ("cls_token", "pos_embed", "register_tokens"):
        o.put_tensor(f"{p}.{name}", o.sd[f"{p}.{name}"])
    o.put(f"{p}.norm", f"{p}.norm")
    for i in range(depth):
        _vggt_block(o, f"{p}.blocks.{i}", f"{p}.blocks.{i}", qk_norm=False)


def _dpt_head(o: _Out, p: str, gs: bool) -> None:
    o.put(f"{p}.norm", f"{p}.norm")
    for i in range(4):
        o.put(f"{p}.projects_{i}", f"{p}.projects.{i}")
    for i in (0, 1, 3):
        o.put(f"{p}.resize_{i}", f"{p}.resize_layers.{i}")
    for i in range(1, 5):
        o.put(f"{p}.layer{i}_rn", f"{p}.scratch.layer{i}_rn", ("weight",))
        rp, dp = f"{p}.scratch.refinenet{i}", f"{p}.refinenet{i}"
        o.put(f"{dp}.out_conv", f"{rp}.out_conv")
        units = ("resConfUnit2",)
        if o.has(f"{rp}.resConfUnit1.conv1.weight"):
            units = ("resConfUnit1", "resConfUnit2")
        for unit in units:
            for conv in ("conv1", "conv2"):
                o.put(f"{dp}.{unit}.{conv}", f"{rp}.{unit}.{conv}")
    o.put(f"{p}.output_conv1", f"{p}.scratch.output_conv1")
    for i in (0, 2):
        o.put(f"{p}.output_conv2_{i}", f"{p}.scratch.output_conv2.{i}")
    if gs and o.has(f"{p}.input_merger.0.weight"):
        o.put(f"{p}.input_merger", f"{p}.input_merger.0")


def _camera_head(o: _Out, p: str, trunk_depth: int) -> None:
    for name in ("token_norm", "trunk_norm", "embed_pose"):
        o.put(f"{p}.{name}", f"{p}.{name}")
    o.put_tensor(f"{p}.empty_pose_tokens", o.sd[f"{p}.empty_pose_tokens"])
    o.put(f"{p}.poseLN_modulation", f"{p}.poseLN_modulation.1")
    o.put(f"{p}.pose_branch_fc1", f"{p}.pose_branch.fc1")
    o.put(f"{p}.pose_branch_fc2", f"{p}.pose_branch.fc2")
    for i in range(trunk_depth):
        _vggt_block(o, f"{p}.trunk.{i}", f"{p}.trunk.{i}", qk_norm=False)


def convert_vggt_checkpoint(sd: Mapping, depth: int = 24,
                            dinov2_depth: int = 24, has_gs_head: bool = True,
                            trunk_depth: int = 4) -> dict[str, torch.Tensor]:
    """A reference VGGT / SPFSplatV2-L state dict (tensors or arrays,
    keys optionally prefixed "encoder.", "model." or "backbone.model.")
    -> the port's state dict."""
    o = _Out({re.sub(r"^(encoder\.|model\.|backbone\.model\.)", "", k): v
              for k, v in sd.items()})
    _dinov2(o, "aggregator.patch_embed", dinov2_depth)
    o.put_tensor("aggregator.camera_token", o.sd["aggregator.camera_token"][0])
    o.put_tensor("aggregator.register_token",
                 o.sd["aggregator.register_token"][0])
    for i in range(depth):
        for kind in ("frame_blocks", "global_blocks"):
            _vggt_block(o, f"aggregator.{kind}.{i}", f"aggregator.{kind}.{i}",
                        qk_norm=True)
    if o.has("aggregator.intrinsic_encoder.weight"):
        o.put("aggregator.intrinsic_encoder", "aggregator.intrinsic_encoder")
    if o.has("camera_head.token_norm.weight"):
        _camera_head(o, "camera_head", trunk_depth)
    if o.has("point_head.norm.weight"):
        _dpt_head(o, "point_head", gs=False)
    if has_gs_head and o.has("gaussian_param_head.norm.weight"):
        _dpt_head(o, "gaussian_param_head", gs=True)
    return o.out
