"""Typed configuration: dataclasses + YAML overlays + CLI overrides (torch
port of `spfsplatv2_tpu/config.py`).

A typed root config composed of per-subsystem dataclasses, YAML
experiment files overlaying the defaults, and dotted-path command-line
overrides (`a.b.c=value`, list nodes by integer index:
`datasets.0.dataset.roots=[...]`).  Files and override values are read
by `utils/yaml_lite.py`, which gives PyYAML's `safe_load` objects for
the subset the presets use; PyYAML is not needed.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Optional, get_args, get_origin

from spfsplatv2_tpu_torch.data.dataset import DatasetConfig
from spfsplatv2_tpu_torch.data.view_samplers import (
    ArbitrarySamplerConfig,
    BoundedSamplerConfig,
    EvaluationSamplerConfig,
)
from spfsplatv2_tpu_torch.models import EncoderSelectorConfig
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.training.optim import OptimizerConfig
from spfsplatv2_tpu_torch.training.step import LossConfig
from spfsplatv2_tpu_torch.utils import yaml_lite


@dataclass(frozen=True)
class TrainerConfig:
    max_steps: int = 300_001
    val_check_interval: int = 10_000
    batch_size: int = 16
    seed: int = 111_123
    num_nodes: int = 1
    # Gradient accumulation: batches are processed in chunks of this size
    # with gradients averaged before the single optimizer update
    # (numerically the full-batch step; activation memory scales with the
    # chunk).  0 = off.
    microbatch: int = 0
    # Device-memory budget of the guard (GiB).  None = the card's total.
    # Before training, one probe forward + backward at the candidate
    # microbatch measures the peak (`training/loop.py:probe_peak_gb`), and
    # the loop halves `microbatch` until it fits, or raises.
    hbm_budget_gb: Optional[float] = None


@dataclass(frozen=True)
class CheckpointingConfig:
    every_n_train_steps: int = 10_000
    save_top_k: int = 1
    resume: bool = False
    load: Optional[str] = None
    pretrained_weights: Optional[str] = None


@dataclass(frozen=True)
class TrainFlags:
    training_context: bool = False
    random_drop_context_views: bool = False
    random_drop_target_views: bool = False
    # Distillation teacher: "" disables; "dust3r"/"mast3r" enable the frozen
    # teacher (training/loop.py) for the steps up to distill_max_steps.
    distiller: str = ""
    distiller_weights: Optional[str] = None
    distill_max_steps: int = 0
    print_log_every_n_steps: int = 100
    # Keyword parameter freezing for fine-tuning recipes
    # (optim.FreezeConfig for semantics).
    freeze_pretrained: bool = False
    freeze_backbone: bool = False
    freeze_pose_head: bool = False


@dataclass(frozen=True)
class TestFlags:
    align_pose: bool = False
    pose_align_steps: int = 100
    opt_lr: float = 5e-4
    compute_scores: bool = True
    save_image: bool = False
    save_video: bool = False
    output_path: str = "outputs/test"


@dataclass(frozen=True)
class DatasetEntry:
    """One dataset of a (possibly heterogeneous) multi-dataset recipe: a
    full `DatasetConfig` (own roots, shapes, filters) and its own sampler
    selection; one batch of each entry is drawn every step and the
    batches are concatenated.
    """

    name: str = "re10k"
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    view_sampler_name: str = "bounded"
    view_sampler: BoundedSamplerConfig = field(default_factory=BoundedSamplerConfig)
    evaluation_sampler: EvaluationSamplerConfig = field(
        default_factory=EvaluationSamplerConfig
    )
    arbitrary_sampler: ArbitrarySamplerConfig = field(
        default_factory=ArbitrarySamplerConfig
    )


@dataclass(frozen=True)
class RootConfig:
    mode: str = "train"
    # Variant-discriminated encoder selection: encoder.name picks the
    # family, encoder.<name>.* configures it.
    encoder: EncoderSelectorConfig = field(default_factory=EncoderSelectorConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    # Sampler selection: view_sampler_name picks the kind, the matching
    # config block applies.
    view_sampler_name: str = "bounded"
    view_sampler: BoundedSamplerConfig = field(default_factory=BoundedSamplerConfig)
    evaluation_sampler: EvaluationSamplerConfig = field(
        default_factory=EvaluationSamplerConfig
    )
    arbitrary_sampler: ArbitrarySamplerConfig = field(
        default_factory=ArbitrarySamplerConfig
    )
    # Heterogeneous multi-dataset training: when non-empty, OVERRIDES the
    # single `dataset`/sampler fields above.  One batch of
    # `trainer.batch_size` examples is drawn from EACH entry per step and
    # the batches are concatenated, so the effective step batch is
    # batch_size * len(datasets).  Entries may differ
    # in roots, shapes, filters, and view samplers; concatenation requires
    # equal input_image_shape and view counts (asserted in the loop).
    datasets: tuple[DatasetEntry, ...] = ()
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    checkpointing: CheckpointingConfig = field(default_factory=CheckpointingConfig)
    train: TrainFlags = field(default_factory=TrainFlags)
    test: TestFlags = field(default_factory=TestFlags)
    image_shape: tuple[int, int] = (256, 256)
    output_dir: str = "outputs"


def dataset_entries(cfg: "RootConfig") -> tuple[DatasetEntry, ...]:
    """The recipe's datasets as uniform entries.

    `datasets` (multi-dataset recipes) wins; otherwise the single
    `dataset` + top-level sampler fields are wrapped into one entry.
    """
    if cfg.datasets:
        return cfg.datasets
    return (
        DatasetEntry(
            name="default",
            dataset=cfg.dataset,
            view_sampler_name=cfg.view_sampler_name,
            view_sampler=cfg.view_sampler,
            evaluation_sampler=cfg.evaluation_sampler,
            arbitrary_sampler=cfg.arbitrary_sampler,
        ),
    )


def make_sampler_for_entry(entry: DatasetEntry, stage: str):
    """Build one dataset entry's configured view sampler.

    At test time, a configured `evaluation_sampler.index_path` switches a
    training (bounded) sampler to the frozen-index evaluation sampler.
    The shipped index tables live in assets/evaluation_index_*.json.
    """
    from spfsplatv2_tpu_torch.data.view_samplers import make_view_sampler

    kind = entry.view_sampler_name
    if (
        stage == "test"
        and kind == "bounded"
        and entry.evaluation_sampler.index_path
    ):
        kind = "evaluation"
    sampler_cfg = {
        "bounded": entry.view_sampler,
        "evaluation": entry.evaluation_sampler,
        "arbitrary": entry.arbitrary_sampler,
        "all": None,
    }[kind]
    return make_view_sampler(kind, sampler_cfg, stage=stage)


def make_sampler_from_config(cfg: "RootConfig", stage: str):
    """Build the configured view sampler.

    Multi-dataset recipes: uses the FIRST entry (callers that need all
    samplers should iterate `dataset_entries`).
    """
    return make_sampler_for_entry(dataset_entries(cfg)[0], stage)


def _coerce(value: Any, typ: Any) -> Any:
    origin = get_origin(typ)
    if typ is Any or value is None:
        return value
    if is_dataclass(typ):
        return _from_dict(typ, value)
    if origin is tuple:
        args = get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        return tuple(_coerce(v, t) for v, t in zip(value, args))
    if origin in (list,):
        (arg,) = get_args(typ) or (Any,)
        return [_coerce(v, arg) for v in value]
    if origin is not None and str(origin) in ("typing.Union", "types.UnionType"):
        for arg in get_args(typ):
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
        return value
    if typ in (int, float, str, bool):
        if typ is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return typ(value)
    return value


def _from_dict(cls, data: dict):
    if not isinstance(data, dict):
        raise TypeError(f"expected mapping for {cls.__name__}, got {type(data)}")
    kwargs = {}
    valid = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in valid:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        kwargs[key] = _coerce(value, _resolve(cls, valid[key]))
    return cls(**kwargs)


def _resolve(cls, f):
    import typing

    hints = typing.get_type_hints(cls)
    return hints[f.name]


def _to_dict(cfg) -> Any:
    if is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return [_to_dict(v) for v in cfg]
    return cfg


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_override(s: str) -> tuple[list[str], Any]:
    key, _, value = s.partition("=")
    return key.split("."), yaml_lite.safe_load(value)


def load_config(
    yaml_paths: list[str | Path] | None = None,
    overrides: list[str] | None = None,
    base: Optional[RootConfig] = None,
) -> RootConfig:
    """Compose a RootConfig from defaults + YAML overlays + CLI overrides."""
    data = _to_dict(base or RootConfig())
    for path in yaml_paths or []:
        overlay = yaml_lite.safe_load(Path(path).read_text()) or {}
        data = _deep_merge(data, overlay)
    for override in overrides or []:
        path, value = _parse_override(override)
        node = data
        for key in path[:-1]:
            # List nodes (e.g. `datasets.0.dataset.roots=[...]`) are
            # addressed by integer index.
            if isinstance(node, list):
                node = node[int(key)]
            else:
                node = node.setdefault(key, {})
        if isinstance(node, list):
            node[int(path[-1])] = value
        else:
            node[path[-1]] = value
    return _from_dict(RootConfig, data)
