"""View samplers: choose context/target frame indices per scene (copy of
`spfsplatv2_tpu/data/view_samplers.py`):
  * bounded: random context gap within a [min, max] window that linearly
    warms up with the global training step; targets drawn inside the gap;
    at test time the full gap with all intermediate frames as targets;
  * evaluation: fixed (context, target) indices from a JSON index, with
    2-view indices widened to N context views;
  * arbitrary: fixed or random index lists;
  * all: every frame as both context and target.

Samplers are host-side numpy; the training step never sees them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class BoundedSamplerConfig:
    num_context_views: int = 2
    num_target_views: int = 1
    min_distance_between_context_views: int = 45
    max_distance_between_context_views: int = 150
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 200_000
    initial_min_distance_between_context_views: int = 25
    initial_max_distance_between_context_views: int = 45


class BoundedViewSampler:
    def __init__(self, cfg: BoundedSamplerConfig, stage: str = "train"):
        self.cfg = cfg
        self.stage = stage

    def _schedule(self, initial: int, final: int, global_step: int) -> int:
        frac = global_step / max(self.cfg.warm_up_steps, 1)
        return min(initial + int((final - initial) * frac), final)

    def sample(
        self,
        scene: str,
        num_views: int,
        rng: np.random.Generator,
        global_step: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        if self.stage == "test":
            min_gap = max_gap = cfg.max_distance_between_context_views
        elif cfg.warm_up_steps > 0:
            max_gap = self._schedule(
                cfg.initial_max_distance_between_context_views,
                cfg.max_distance_between_context_views,
                global_step,
            )
            min_gap = self._schedule(
                cfg.initial_min_distance_between_context_views,
                cfg.min_distance_between_context_views,
                global_step,
            )
        else:
            min_gap = cfg.min_distance_between_context_views
            max_gap = cfg.max_distance_between_context_views

        max_gap = min(num_views - 1, max_gap)
        min_gap = max(2 * cfg.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise ValueError("Example does not have enough frames!")
        gap = int(rng.integers(min_gap, max_gap + 1))

        left = int(rng.integers(num_views - gap))
        if self.stage == "test":
            left = 0
        right = left + gap

        if self.stage == "test":
            targets = np.arange(left, right + 1)
        else:
            targets = rng.integers(
                left + cfg.min_distance_to_context_views,
                right + 1 - cfg.min_distance_to_context_views,
                size=(cfg.num_target_views,),
            )

        extra: list[int] = []
        if cfg.num_context_views > 2:
            want = cfg.num_context_views - 2
            if right - left - 1 < want:
                raise ValueError("Example does not have enough frames!")
            while len(set(extra)) != want:
                extra = rng.integers(left + 1, right, size=(want,)).tolist()

        context = np.asarray([left, *extra, right], dtype=np.int64)
        return context, np.asarray(targets, dtype=np.int64)


@dataclass(frozen=True)
class EvaluationSamplerConfig:
    index_path: str = ""
    num_context_views: int = 2


class EvaluationViewSampler:
    """Fixed per-scene indices from an evaluation index JSON."""

    def __init__(self, cfg: EvaluationSamplerConfig, stage: str = "test"):
        self.cfg = cfg
        with open(cfg.index_path) as f:
            self.index = {k: v for k, v in json.load(f).items() if v is not None}

    def overlap_for(self, scene: str):
        """Context-overlap value of this scene's index entry (or None)."""
        entry = self.index.get(scene)
        return None if entry is None else entry.get("overlap")

    def sample(self, scene: str, num_views: int, rng=None, global_step: int = 0):
        entry = self.index.get(scene)
        if entry is None:
            raise ValueError(f"no evaluation index entry for scene {scene}")
        context = np.asarray(entry["context"], dtype=np.int64)
        target = np.asarray(entry["target"], dtype=np.int64)
        # Widen 2-view indices to N views by interpolating extra context
        # frames inside the pair.
        want = self.cfg.num_context_views
        if want > len(context):
            extra = np.linspace(context[0], context[-1], want).round().astype(
                np.int64
            )
            context = np.unique(np.concatenate([context, extra]))
        return context, target


@dataclass(frozen=True)
class ArbitrarySamplerConfig:
    context_views: Optional[Sequence[int]] = None
    target_views: Optional[Sequence[int]] = None
    num_context_views: int = 2
    num_target_views: int = 1


class ArbitraryViewSampler:
    def __init__(self, cfg: ArbitrarySamplerConfig, stage: str = "train"):
        self.cfg = cfg

    def sample(self, scene: str, num_views: int, rng: np.random.Generator,
               global_step: int = 0):
        cfg = self.cfg
        if cfg.context_views is not None:
            context = np.asarray(cfg.context_views, dtype=np.int64)
        else:
            context = np.sort(
                rng.choice(num_views, size=cfg.num_context_views, replace=False)
            )
        if cfg.target_views is not None:
            target = np.asarray(cfg.target_views, dtype=np.int64)
        else:
            target = rng.choice(num_views, size=cfg.num_target_views, replace=True)
        return context, target


class AllViewSampler:
    def __init__(self, cfg=None, stage: str = "test"):
        pass

    def sample(self, scene: str, num_views: int, rng=None, global_step: int = 0):
        idx = np.arange(num_views, dtype=np.int64)
        return idx, idx


def make_view_sampler(kind: str, cfg=None, stage: str = "train"):
    if kind == "bounded":
        return BoundedViewSampler(cfg or BoundedSamplerConfig(), stage)
    if kind == "evaluation":
        return EvaluationViewSampler(cfg, stage)
    if kind == "arbitrary":
        return ArbitraryViewSampler(cfg or ArbitrarySamplerConfig(), stage)
    if kind == "all":
        return AllViewSampler(cfg, stage)
    raise ValueError(f"unknown view sampler {kind!r}")
