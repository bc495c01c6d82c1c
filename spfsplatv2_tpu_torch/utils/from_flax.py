"""Flax param tree -> the port's `state_dict`, and a JAX train state ->
the port's checkpoint.

Inverts the layouts that `spfsplatv2_tpu/utils/ckpt_convert.py` converts
from torch (the port keeps its own copy of the rules):
  * Dense kernel (in, out)          -> weight (out, in)
  * Conv kernel HWIO                -> weight OIHW
  * ConvTranspose(transpose_kernel=True) kernel (kh, kw, out, in)
                                    -> weight (in, out, kh, kw)
    (the same axis permutation as Conv: (3, 2, 0, 1))
  * LayerNorm scale                 -> weight
  * `enc_blocks_{i}`, `dec_blocks_{i}`, `dec_blocks2_{i}` (CroCo),
    `blocks_{i}`, `frame_blocks_{i}`, `global_blocks_{i}`, `trunk_{i}`
    (VGGT) -> ModuleList index `enc_blocks.{i}`, ...
The port names its modules after the flax modules, so every other path
component carries over as it is.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LIST = re.compile(r"^(enc_blocks|dec_blocks|dec_blocks2|blocks|frame_blocks|"
                   r"global_blocks|trunk)_(\d+)$")


def _module_key(name: str) -> str:
    m = _LIST.match(name)
    return f"{m.group(1)}.{m.group(2)}" if m else name


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))
        raise ValueError(f"unexpected {value.ndim}-d kernel")
    if name == "scale":
        return "weight", value
    return name, value


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """`params` is `encoder.init(...)` (with or without the top-level
    "params" collection), as nested dicts of arrays."""
    if set(params) == {"params"}:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: list[str]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [_module_key(name)])
            else:
                leaf, arr = _leaf(name, np.asarray(value))
                key = ".".join(prefix + [leaf])
                # A copy: JAX arrays read through numpy are not writable.
                out[key] = torch.from_numpy(np.array(arr, order="C"))

    walk(params, [])
    return out


def checkpoint_from_flax(params: Mapping, mu: Mapping, nu: Mapping, count: int,
                         step: int, skipped_count: int = 0) -> dict:
    """A JAX `TrainState` (as numpy trees) -> the port's checkpoint dict
    (`training/loop.py:checkpoint_dict`).

    `params` is the param tree; `mu` and `nu` are optax AdamW's first and
    second moments over the same tree (the label groups' moments merged);
    `count` is AdamW's count of applied updates, `step` the state's step
    and `skipped_count` the skip wrapper's count.  The moments take the
    weights' layouts.
    """
    return {"step": int(step), "count": int(count),
            "skipped_count": int(skipped_count),
            "encoder": flax_to_state_dict(params),
            "mu": flax_to_state_dict(mu), "nu": flax_to_state_dict(nu)}
