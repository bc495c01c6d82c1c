"""Optimizer: two-group AdamW + warm-up/cosine schedule + clip + bad-gradient
skip (torch port of `spfsplatv2_tpu/training/optim.py`).

The semantics are the JAX chain's, step for step:
  * max|g| is taken over the unclipped gradients of the trainable
    parameters; if it is NaN or above `max_grad_skip`, nothing moves (no
    parameter, no moment, no schedule count) and `skipped_count` rises;
  * otherwise the gradients are clipped to global norm `grad_clip`
    (optax's rule: g when the norm is below the limit, else g / norm *
    limit), then AdamW (decoupled decay on every parameter, biases and
    norms included) runs with freshly-initialised heads at `lr` and the
    pretrained rest at `lr * backbone_lr_multiplier`;
  * the rate is a linear warm-up from lr / warm_up_steps to lr, then a
    cosine decay to `lr * min_lr_multiplier`, evaluated at the count of
    APPLIED updates (skipped steps do not advance it).
Frozen parameters (`FreezeConfig`) get neither updates nor decay and do
not enter the skip test or the clip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from spfsplatv2_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    warm_up_steps: int = 2000
    max_steps: int = 300_001
    backbone_lr_multiplier: float = 0.1
    min_lr_multiplier: float = 0.01
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 0.5
    max_grad_skip: float = 5.0


NEW_PARAM_KEYWORDS = (
    "gaussian_param_head",
    "intrinsic_encoder",
    "pose_head",
    "camera_head",
)
# freeze_pretrained keeps ONLY these heads trainable.
FREEZE_UNFREEZE_KEYWORDS = ("gaussian_param_head", "pose_head",
                            "intrinsic_encoder")


@dataclass(frozen=True)
class FreezeConfig:
    """Keyword parameter freezing for fine-tuning recipes: precedence
    pose_head > pretrained > backbone, as in the JAX package."""

    freeze_pretrained: bool = False
    freeze_backbone: bool = False
    freeze_pose_head: bool = False

    @property
    def any(self) -> bool:
        return (self.freeze_pretrained or self.freeze_backbone
                or self.freeze_pose_head)

    def is_frozen(self, name: str) -> bool:
        if self.freeze_pose_head and "pose_head" in name:
            return True
        if self.freeze_pretrained:
            return not any(k in name for k in FREEZE_UNFREEZE_KEYWORDS)
        return self.freeze_backbone and "backbone" in name


def param_label(name: str, freeze: FreezeConfig = FreezeConfig()) -> str:
    """'frozen' per `freeze`; else 'new' for freshly-initialised heads and
    'pretrained' for the rest."""
    if freeze.is_frozen(name):
        return "frozen"
    return "new" if any(k in name for k in NEW_PARAM_KEYWORDS) else "pretrained"


def make_schedule(cfg: OptimizerConfig, multiplier: float = 1.0):
    """count -> learning rate: optax's join of its linear and cosine
    schedules, in float32 as optax evaluates them (the warm-up's first
    value, peak / warm, comes out of a cancelling float32 sum)."""
    f32 = np.float32
    peak = cfg.lr * multiplier
    warm = cfg.warm_up_steps
    decay_steps = max(cfg.max_steps - warm, 1)
    alpha = cfg.min_lr_multiplier

    def schedule(count: int) -> float:
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return float(f32(peak / warm - peak) * frac + f32(peak))
        t = f32(min(count - warm, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class Optimizer:
    """The JAX optimizer chain over named parameters.

    `step()` reads each trainable parameter's `.grad` (None counts as
    zero, as an unused leaf's gradient is in JAX) and either applies one
    update or skips; `skipped_count`, `last_max_grad` and `count` (applied
    updates) mirror the JAX optimizer state.
    """

    def __init__(self, cfg: OptimizerConfig,
                 named_params: Iterable[tuple[str, torch.nn.Parameter]],
                 freeze: FreezeConfig = FreezeConfig()):
        self.cfg = cfg
        groups = {"new": [], "pretrained": []}
        for name, p in named_params:
            label = param_label(name, freeze)
            if label != "frozen":
                groups[label].append(p)
        self.params = groups["new"] + groups["pretrained"]
        self.schedules = {"new": make_schedule(cfg, 1.0),
                          "pretrained": make_schedule(
                              cfg, cfg.backbone_lr_multiplier)}
        self.adamw = torch.optim.AdamW(
            [{"params": groups[k], "label": k} for k in groups if groups[k]],
            lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
        self.count = 0
        self.skipped_count = 0
        self.last_max_grad = 0.0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Apply one update or skip it; returns whether it was applied."""
        with span("train.optimizer"):
            return self._step()

    def _step(self) -> bool:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        max_grad = float(torch.stack([g.abs().max() for g in grads]).max())
        self.last_max_grad = max_grad
        if not max_grad <= self.cfg.max_grad_skip:   # NaN compares False
            self.skipped_count += 1
            return False
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        if not bool(norm < self.cfg.grad_clip):
            for g in grads:
                g.copy_(g / norm * self.cfg.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.adamw.step()
        self.count += 1
        return True

    def lr(self, label: str = "new") -> float:
        """The rate the next applied update uses."""
        return self.schedules[label](self.count)
