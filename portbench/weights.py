"""Seeded random weights, made on the device by the benchmark itself.

The plan of a model comes from the reference's module tree (built on the
meta device): every Linear, Conv2d and ConvTranspose2d weight gets a
LeCun truncated normal (fan-in rule), LayerNorm weights 1, LayerScale
gammas their init value, every other leaf 0; the configuration file's
`init_rules` then set the few calibrated leaves (output layers, tokens)
by name.  The random leaves are drawn in sorted name order from one
`torch.Generator` on the device, in groups of up to `GROUP` numbers a
call, so the same seed gives the same weights to the program and to the
reference, which each receive them by name.
"""

from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass

import torch
from torch import nn

GROUP = 1 << 27  # random numbers drawn in one call
# The +-2 sigma truncated normal by inverse CDF (flax's initializer).
_TRUNC_STD = 0.87962566103423978
_PHI_LO, _PHI_HI = 0.022750131948179195, 0.9772498680518208


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple[int, ...]
    std: float | None          # truncated normal of this std, or
    values: tuple | float = 0  # a constant (a scalar or a vector)


def _fan_in(shape, transposed: bool) -> int:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[0 if transposed else 1] * receptive


def make_plan(model: nn.Module, rules: list[dict]) -> list[Leaf]:
    """The leaves of `model` (any device, meta included) in sorted name
    order, each with its rule; `rules` are the config file's
    `init_rules`: {"match": glob, "lecun_scale": s} | {"std": s} |
    {"values": v}."""
    leaves = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            std, values = None, 0.0
            if (isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))
                    and pname == "weight"):
                fan = _fan_in(shape, isinstance(mod, nn.ConvTranspose2d))
                std = math.sqrt(1.0 / fan)
            elif isinstance(mod, nn.LayerNorm) and pname == "weight":
                values = 1.0
            elif pname == "gamma" and hasattr(mod, "init_value"):
                values = float(mod.init_value)
            for rule in rules:
                if not fnmatch.fnmatchcase(name, rule["match"]):
                    continue
                if "lecun_scale" in rule:
                    fan = _fan_in(shape, isinstance(mod, nn.ConvTranspose2d))
                    std, values = math.sqrt(rule["lecun_scale"] / fan), 0.0
                elif "std" in rule:
                    std, values = float(rule["std"]), 0.0
                else:
                    v = rule["values"]
                    std, values = None, (tuple(v) if isinstance(v, list) else float(v))
            leaves[name] = Leaf(name, shape, std, values)
    return [leaves[k] for k in sorted(leaves)]


def generate(plan: list[Leaf], seed: int, device):
    """Yield (name, float32 tensor on `device`) for every leaf of `plan`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pending: list[Leaf] = []

    def draw():
        n = sum(math.prod(l.shape) for l in pending)
        u = torch.empty(n, dtype=torch.float32, device=device)
        u.uniform_(_PHI_LO, _PHI_HI, generator=gen)
        u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0) / _TRUNC_STD)
        off = 0
        for leaf in pending:
            k = math.prod(leaf.shape)
            yield leaf.name, u[off:off + k].view(leaf.shape) * leaf.std
            off += k
        pending.clear()

    for leaf in plan:
        if leaf.std is None:
            if isinstance(leaf.values, tuple):
                t = torch.tensor(leaf.values, dtype=torch.float32,
                                 device=device).expand(leaf.shape)
            else:
                t = torch.full(leaf.shape, leaf.values, dtype=torch.float32,
                               device=device)
            yield leaf.name, t
            continue
        pending.append(leaf)
        if sum(math.prod(l.shape) for l in pending) >= GROUP:
            yield from draw()
    if pending:
        yield from draw()


@torch.no_grad()
def load(model: nn.Module, plan: list[Leaf], seed: int) -> None:
    """Fill every parameter of `model` from the plan; the names must match
    the plan's one for one."""
    params = dict(model.named_parameters())
    names = {l.name for l in plan}
    if set(params) != names:
        extra, missing = sorted(set(params) - names), sorted(names - set(params))
        raise ValueError(f"weights: the model and the plan disagree "
                         f"(model only: {extra[:5]}, plan only: {missing[:5]})")
    device = next(iter(params.values())).device
    for name, t in generate(plan, seed, device):
        params[name].copy_(t)
