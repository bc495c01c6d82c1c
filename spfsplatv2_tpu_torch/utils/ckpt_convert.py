"""MASt3R / DUSt3R / SPFSplat state dicts -> the port's state dicts (torch
port of `spfsplatv2_tpu/utils/ckpt_convert.py`, its own copy of the key
rules).

  reference                                  port
  [encoder.][backbone.]patch_embed.proj.*  -> backbone.patch_embed.proj.*
    (resampled to the patch size when it differs, FlexiViT pinv resize)
  [backbone.]{enc,dec}_blocks{,2}.{i}.*    -> backbone.{enc,dec}_blocks{,2}.{i}.*
  [backbone.]{enc_norm,decoder_embed,dec_norm,intrinsic_encoder,pose_token}
                                           -> backbone.* (the same names)
  downstream_head{n}.dpt.act_postprocess.{k}.{0,1}
                                           -> downstream_head{n}.core.act_{k}_{proj,up|down}
  .dpt.scratch.{layer*_rn,refinenet*}.*    -> .core.*
  .dpt.head.{0,2,4}                        -> .head_conv1, .head_conv2, .head_out
  gaussian_param_head{n}.dpt.input_merger.0, .dpt.head.{0,4}
                                           -> .input_merger, .head_conv, .head_out
  pose_head / pose_head2 .more_mlps.{0,2}, .fc_t, .fc_rot
                                           -> pose_head{1,2}.mlp1, .mlp2, .fc_t, .fc_rot

Both sides are torch layouts, so the weights move unchanged.  A
checkpoint without a second decoder has its `dec_blocks` duplicated into
`dec_blocks2`; the SPFSplat converter strips the DPT heads' confidence
channel, the DUSt3R one keeps it.  The reference's
`refinenet4.resConfUnit1` is dropped: its forward never calls it (the
deepest fusion block has no skip input) and the port's block has none.
Nothing here reads a file: load the checkpoint with `torch.load` and
pass its dict.  `utils/reference_checkpoint.py` makes seeded state dicts
in these layouts.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from spfsplatv2_tpu_torch.utils.ckpt_convert_vggt import _Out
from spfsplatv2_tpu_torch.utils.interp import resize_bilinear

_HEAD_PREFIXES = ("downstream_head", "gaussian_param_head", "pose_head")
_ACT = (("act_0_proj", "0.0"), ("act_0_up", "0.1"), ("act_1_proj", "1.0"),
        ("act_1_up", "1.1"), ("act_2_proj", "2.0"), ("act_3_proj", "3.0"),
        ("act_3_down", "3.1"))


def resample_patch_embed(kernel_oihw, new_hw: tuple[int, int]) -> torch.Tensor:
    """Resize a patch-embed kernel (o, i, h, w) to `new_hw` by the
    pseudo-inverse of the bilinear resize of a patch (FlexiViT)."""
    kernel = torch.as_tensor(np.asarray(kernel_oihw, np.float32))
    o, i, h, w = kernel.shape
    nh, nw = new_hw
    if (h, w) == (nh, nw):
        return kernel
    basis = torch.eye(h * w).reshape(-1, h, w, 1)
    mat = resize_bilinear(basis, (nh, nw), align_corners=False)
    pinv = np.linalg.pinv(mat.reshape(-1, nh * nw).numpy())   # (nh*nw, h*w)
    flat = kernel.reshape(o * i, h * w).numpy()
    return torch.from_numpy(flat @ pinv.T).reshape(o, i, nh, nw)


def _normalize_keys(sd: Mapping, keep: tuple[str, ...]) -> dict:
    """Drop a leading "encoder.", prefix the trunk's keys with "backbone."
    when none has it, and duplicate `dec_blocks` into `dec_blocks2` when
    the checkpoint has no second decoder."""
    sd = {re.sub(r"^encoder\.", "", k): v for k, v in sd.items()}
    if not any(k.startswith("backbone.") for k in sd):
        sd = {(k if k.startswith(keep) else f"backbone.{k}"): v
              for k, v in sd.items()}
    if not any("dec_blocks2" in k for k in sd):
        for k in list(sd):
            if ".dec_blocks." in k:
                sd[k.replace(".dec_blocks.", ".dec_blocks2.")] = sd[k]
    return sd


def _croco_block(o: _Out, p: str, cross: bool) -> None:
    names = ["norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"]
    if cross:
        names += ["norm3", "norm_y"] + [f"cross_attn.{n}" for n in
                                        ("projq", "projk", "projv", "proj")]
    for name in names:
        o.put(f"{p}.{name}", f"{p}.{name}")


def _dpt_head(o: _Out, p: str, gs: bool, strip_conf: bool) -> None:
    src, core = f"{p}.dpt", f"{p}.core"
    for name, idx in _ACT:
        o.put(f"{core}.{name}", f"{src}.act_postprocess.{idx}")
    for i in range(1, 5):
        o.put(f"{core}.layer{i}_rn", f"{src}.scratch.layer{i}_rn", ("weight",))
        units = ("resConfUnit2",) if i == 4 else ("resConfUnit1", "resConfUnit2")
        rp, dp = f"{src}.scratch.refinenet{i}", f"{core}.refinenet{i}"
        o.put(f"{dp}.out_conv", f"{rp}.out_conv")
        for unit in units:
            for conv in ("conv1", "conv2"):
                o.put(f"{dp}.{unit}.{conv}", f"{rp}.{unit}.{conv}")
    if gs:
        o.put(f"{p}.input_merger", f"{src}.input_merger.0")
        o.put(f"{p}.head_conv", f"{src}.head.0", ("weight",))
        o.put(f"{p}.head_out", f"{src}.head.4")
        return
    o.put(f"{p}.head_conv1", f"{src}.head.0")
    o.put(f"{p}.head_conv2", f"{src}.head.2")
    o.put(f"{p}.head_out", f"{src}.head.4")
    if strip_conf and o.out[f"{p}.head_out.weight"].shape[0] == 4:
        for leaf in ("weight", "bias"):
            key = f"{p}.head_out.{leaf}"
            o.out[key] = o.out[key][:3]


def _trunk(o: _Out, enc_depth: int, dec_depth: int,
           patch_hw: tuple[int, int]) -> None:
    pe = o.sd["backbone.patch_embed.proj.weight"]
    if tuple(pe.shape[-2:]) != tuple(patch_hw):
        pe = resample_patch_embed(pe, patch_hw)
    o.put_tensor("backbone.patch_embed.proj.weight", pe)
    o.put_tensor("backbone.patch_embed.proj.bias",
                 o.sd["backbone.patch_embed.proj.bias"])
    for i in range(enc_depth):
        _croco_block(o, f"backbone.enc_blocks.{i}", cross=False)
    for i in range(dec_depth):
        _croco_block(o, f"backbone.dec_blocks.{i}", cross=True)
        _croco_block(o, f"backbone.dec_blocks2.{i}", cross=True)
    for name in ("enc_norm", "decoder_embed", "dec_norm"):
        o.put(f"backbone.{name}", f"backbone.{name}")
    if o.has("backbone.intrinsic_encoder.weight"):
        o.put("backbone.intrinsic_encoder", "backbone.intrinsic_encoder")
    if o.has("backbone.pose_token"):
        o.put_tensor("backbone.pose_token", o.sd["backbone.pose_token"])


def convert_spfsplat_checkpoint(
    sd: Mapping,
    enc_depth: int = 24,
    dec_depth: int = 12,
    patch_hw: tuple[int, int] = (16, 16),
) -> dict[str, torch.Tensor]:
    """A SPFSplat (v1 or v2) or raw MASt3R state dict (tensors or arrays)
    -> the port encoder's state dict.  Heads missing from the checkpoint
    (the Gaussian and pose heads of a MASt3R one) are missing from the
    result: merge it over a seeded init (`merge_params`)."""
    o = _Out(_normalize_keys(sd, _HEAD_PREFIXES))
    _trunk(o, enc_depth, dec_depth, patch_hw)
    for n in (1, 2):
        if o.has(f"downstream_head{n}.dpt.scratch.layer1_rn.weight"):
            _dpt_head(o, f"downstream_head{n}", gs=False, strip_conf=True)
        if o.has(f"gaussian_param_head{n}.dpt.scratch.layer1_rn.weight"):
            _dpt_head(o, f"gaussian_param_head{n}", gs=True, strip_conf=True)
        src = "pose_head" if n == 1 else "pose_head2"
        if o.has(f"{src}.fc_t.weight"):
            dst = f"pose_head{n}"
            o.put(f"{dst}.mlp1", f"{src}.more_mlps.0")
            o.put(f"{dst}.mlp2", f"{src}.more_mlps.2")
            o.put(f"{dst}.fc_t", f"{src}.fc_t")
            o.put(f"{dst}.fc_rot", f"{src}.fc_rot")
    return o.out


def convert_dust3r_distiller_checkpoint(
    sd: Mapping, enc_depth: int = 24, dec_depth: int = 12,
    patch_hw: tuple[int, int] = (16, 16),
) -> dict[str, torch.Tensor]:
    """A raw DUSt3R / MASt3R state dict -> `Dust3RDistiller`'s state dict:
    the same trunk, and both DPT heads with their confidence channel."""
    o = _Out(_normalize_keys(sd, ("downstream_head",)))
    _trunk(o, enc_depth, dec_depth, patch_hw)
    for n in (1, 2):
        if o.has(f"downstream_head{n}.dpt.scratch.layer1_rn.weight"):
            _dpt_head(o, f"downstream_head{n}", gs=False, strip_conf=False)
    return o.out


def merge_params(model: nn.Module, converted: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy converted weights into `model` in place, leaving what the
    checkpoint lacks at its seeded init.  Raises KeyError on a key the
    model lacks and ValueError on a shape mismatch, before copying any."""
    own = model.state_dict()
    for key, value in converted.items():
        if key not in own:
            raise KeyError(f"converted param {key} not in model")
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: model "
                             f"{tuple(own[key].shape)} vs ckpt "
                             f"{tuple(value.shape)}")
    with torch.no_grad():
        for key, value in converted.items():
            own[key].copy_(value)
    return model

