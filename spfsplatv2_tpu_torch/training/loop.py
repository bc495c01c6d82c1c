"""Training loop orchestration (torch port of
`spfsplatv2_tpu/training/loop.py`).

Builds the encoder, optimizer and train step, streams batches from the
chunked dataset (the view-sampler curriculum reads the live global step),
fits the microbatch to the card's memory, validates and checkpoints.

Under an initialised process group of more than one rank (`torchrun`,
`main.py`) the loop is data-parallel, as the JAX loop is on a mesh: each
rank reads its own shard of the scenes and its own batch of
`trainer.batch_size` (the global batch is batch_size x world size), the
step averages the gradients over the ranks (`make_train_step(mesh=)`),
the ranks agree on the smallest microbatch the memory guard finds, and
rank 0 alone validates, logs and writes checkpoints.

What differs from the JAX loop:
  * batches move to the encoder's device; each rank holds one device;
  * the memory guard probes instead of reading XLA's memory analysis:
    one forward and backward of the probe batch at the candidate
    microbatch, with no update (`probe_peak_gb`, `fit_microbatch`);
  * checkpoints are one `torch.save` file of plain tensors and ints a
    `step_<n>/` directory (`save_checkpoint`);
  * each logged step also carries `time/data_wait_ms`, the host time the
    step waited for its batch.
`checkpointing.pretrained_weights` loads a MASt3R / DUSt3R / SPFSplat
state dict through `utils/ckpt_convert.py`; `train.distiller` adds the
frozen DUSt3R teacher (`models/distiller.py`) for the steps up to
`train.distill_max_steps`.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from spfsplatv2_tpu_torch.config import (
    RootConfig,
    dataset_entries,
    make_sampler_for_entry,
)
from spfsplatv2_tpu_torch.data.dataset import (
    ChunkedSceneDataset,
    collate,
    concat_batches,
)
from spfsplatv2_tpu_torch.losses.lpips import get_lpips
from spfsplatv2_tpu_torch.models import get_encoder
from spfsplatv2_tpu_torch.models.distiller import (
    DistillerConfig,
    Dust3RDistiller,
    build_distiller,
)
from spfsplatv2_tpu_torch.parallel.mesh import make_mesh
from spfsplatv2_tpu_torch.training.optim import FreezeConfig, Optimizer
from spfsplatv2_tpu_torch.training.step import (
    HBMBudgetError,
    TrainState,
    compute_losses,
    init_train_state,
    make_train_step,
)

CHECKPOINT_FILE = "state.pt"


def world_rank() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def agree_microbatch(microbatch: int, device: torch.device) -> int:
    """The smallest of the ranks' microbatches: every rank must run the
    same number of backward passes a step, or DDP waits forever."""
    t = torch.tensor([microbatch], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t)


def batch_iterator(
    dataset: ChunkedSceneDataset,
    batch_size: int,
    get_step: Callable[[], int],
    prefetch: int = 2,
) -> Iterator[dict]:
    """Infinite collated batches; curriculum reads the live global step.

    Batch assembly runs in a daemon thread `prefetch` batches ahead so
    host-side decode overlaps device compute.
    """

    def batches() -> Iterator[dict]:
        epoch = 0
        buf: list[dict] = []
        while True:
            # get_step is passed THROUGH so the view-sampler curriculum
            # advances within an epoch.
            n_epoch = 0
            for example in dataset.epoch(epoch, global_step=get_step):
                n_epoch += 1
                buf.append(example)
                if len(buf) == batch_size:
                    yield collate(buf)
                    buf = []
            if n_epoch == 0:
                # Every scene was filtered or skipped: spinning through
                # empty epochs forever is a silent hang, so fail loudly.
                raise RuntimeError(
                    "dataset epoch yielded zero examples — every scene "
                    "was skipped (check view-sampler distances vs scene "
                    "frame counts, and dataset filters)"
                )
            epoch += 1

    if prefetch <= 0:
        yield from batches()
        return

    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=prefetch)

    def worker():
        try:
            for batch in batches():
                q.put(batch)
        except BaseException as e:  # noqa: BLE001 - surface in consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True,
                     name="batch-prefetch").start()
    while True:
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        yield item


def random_drop_views(batch: dict, rng: np.random.Generator, cfg) -> dict:
    """Random context/target view dropout for multi-view training: keep a
    random count >= 2 of context views (always the first and last) and a
    random count >= 1 of target views, as static-shape (v,) validity
    masks that the train step applies."""
    out = dict(batch)
    if cfg.random_drop_context_views:
        v = batch["context"]["image"].shape[1]
        if v > 2:
            keep = int(rng.integers(2, v + 1))
            middle = rng.permutation(np.arange(1, v - 1))[: keep - 2]
            valid = np.zeros((v,), np.float32)
            valid[[0, v - 1]] = 1.0
            valid[middle] = 1.0
            out["context_valid"] = valid
    if cfg.random_drop_target_views:
        v = batch["target"]["image"].shape[1]
        if v > 1:
            keep = int(rng.integers(1, v + 1))
            idx = rng.permutation(v)[:keep]
            valid = np.zeros((v,), np.float32)
            valid[idx] = 1.0
            out["target_valid"] = valid
    return out


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device`, without "index" and "overlap";
    the (v,) view masks are kept."""
    out = {
        side: {
            k: torch.as_tensor(v, device=device)
            for k, v in batch[side].items()
            if k not in ("index", "overlap")
        }
        for side in ("context", "target")
    }
    for key in ("context_valid", "target_valid"):
        if key in batch:
            out[key] = torch.as_tensor(batch[key], device=device)
    return out


def device_memory_gb(device: torch.device) -> float | None:
    """The card's total memory (GiB), or None off the card."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1] / 2**30


def probe_peak_gb(state: TrainState, batch: dict, microbatch: int,
                  loss_kwargs: dict) -> float | None:
    """Peak device memory (GiB) of one forward + backward of the first
    `microbatch` examples of `batch`, plus the AdamW moments that the
    first update allocates when they do not exist yet.

    Nothing moves: no update, no optimizer count, schedule, step or RNG;
    the gradients are dropped after the reading.  An out-of-memory error
    inside the probe reads as an infinite peak.  None off the card.
    """
    device = next(state.encoder.parameters()).device
    if device.type != "cuda":
        return None
    part = {k: ({kk: t[:microbatch] for kk, t in v.items()}
                if k in ("context", "target") else v)
            for k, v in batch.items()}
    opt = state.optimizer
    moments = 0 if opt.adamw.state else 2 * sum(
        p.numel() * p.element_size() for p in opt.params)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    try:
        loss, _ = compute_losses(state.encoder, part, state.step, **loss_kwargs)
        loss.backward()
        del loss
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    except torch.cuda.OutOfMemoryError:
        peak = float("inf")
    finally:
        state.encoder.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    return (peak + moments) / 2**30


def fit_microbatch(
    probe: Callable[[int], float | None],
    eff_batch: int,
    microbatch: int | None,
    budget_gb: float | None,
) -> tuple[int | None, float | None]:
    """Halve the accumulation microbatch until `probe(microbatch)` (peak
    GiB) fits `budget_gb`; -> (microbatch, its peak).  Raises
    `HBMBudgetError` when it cannot halve further."""
    while True:
        peak_gb = probe(microbatch or eff_batch)
        if peak_gb is not None:
            print(
                f"train step peak HBM {peak_gb:.2f} GB"
                + (f" (budget {budget_gb:.1f} GB)" if budget_gb else ""),
                flush=True,
            )
        if peak_gb is None or budget_gb is None or peak_gb <= budget_gb:
            return microbatch, peak_gb
        new_mb = (microbatch or eff_batch) // 2
        if new_mb < 1 or eff_batch % new_mb != 0:
            raise HBMBudgetError(
                f"train step needs {peak_gb:.2f} GB > {budget_gb:.1f} GB "
                f"HBM and microbatch={microbatch} cannot halve further "
                f"(batch {eff_batch}); shrink the batch/model or raise "
                f"trainer.hbm_budget_gb if paging is acceptable"
            )
        print(
            f"WARNING: step peak HBM {peak_gb:.2f} GB > budget "
            f"{budget_gb:.1f} GB — would silently page; halving "
            f"accumulation microbatch {microbatch or eff_batch} -> {new_mb}",
            flush=True,
        )
        microbatch = new_mb


def run_training(
    cfg: RootConfig,
    max_steps: Optional[int] = None,
    lpips=None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Train; returns {"state", "metrics", "encoder", "guard"}.

    `lpips`: an LPIPS module, else built from `cfg.loss`.  "guard" holds
    the memory guard's chosen microbatch, its peak (GiB, None off the
    card), each probe's microbatch and peak, and its seconds.
    """
    device = torch.device(device)
    world, rank = world_rank()
    mesh = make_mesh(device_type=device.type) if world > 1 else None
    encoder = get_encoder(cfg.encoder, seed=cfg.trainer.seed, device=device)
    if cfg.checkpointing.pretrained_weights:
        load_pretrained_weights(encoder, cfg.encoder,
                                cfg.checkpointing.pretrained_weights)
    # The DUSt3R teacher for the first `distill_max_steps` steps: a step
    # with it and one without it, switched at the cutoff.
    distiller = None
    if cfg.train.distiller and cfg.train.distill_max_steps > 0:
        distiller = load_distiller_params(cfg.train.distiller_weights,
                                          cfg.trainer.seed, device)
    entries = dataset_entries(cfg)
    train_datasets = [
        ChunkedSceneDataset(
            entry.dataset,
            make_sampler_for_entry(entry, "train"),
            stage="train",
            shard_id=rank,
            num_shards=world,
            seed=cfg.trainer.seed + 1000 * i,
        )
        for i, entry in enumerate(entries)
    ]

    state_holder = {"step": 0}
    per_dataset = [
        batch_iterator(ds, cfg.trainer.batch_size, lambda: state_holder["step"])
        for ds in train_datasets
    ]
    if len(per_dataset) == 1:
        batches = per_dataset[0]
    else:
        # One batch per dataset per step, concatenated along the batch
        # axis; each dataset keeps its own sampler and filters.
        def concat_iter():
            for parts in zip(*per_dataset):
                shapes = {p["context"]["image"].shape[1:] for p in parts}
                if len(shapes) != 1:
                    raise ValueError(
                        f"multi-dataset batches must share view counts and "
                        f"image shapes to concatenate, got {shapes}")
                yield concat_batches(parts)

        batches = concat_iter()
    t0 = time.perf_counter()
    first = next(batches)
    wait_ms = (time.perf_counter() - t0) * 1e3

    lpips_calibrated = True
    if lpips is None and cfg.loss.use_lpips:
        lpips, lpips_calibrated = get_lpips(
            cfg.loss.use_lpips, cfg.loss.lpips_weights_path, device=device)

    optimizer = Optimizer(
        cfg.optimizer, encoder.named_parameters(),
        freeze=FreezeConfig(
            freeze_pretrained=cfg.train.freeze_pretrained,
            freeze_backbone=cfg.train.freeze_backbone,
            freeze_pose_head=cfg.train.freeze_pose_head,
        ),
    )
    state = init_train_state(encoder, optimizer)

    start_step = 0
    ckpt_dir = Path(cfg.output_dir) / "checkpoints"
    if cfg.checkpointing.resume:
        restored = restore_latest_checkpoint(ckpt_dir, state)
        if restored is not None:
            state, start_step = restored
            print(f"resumed from step {start_step}", flush=True)

    rng = np.random.default_rng(cfg.trainer.seed + rank)
    total = max_steps if max_steps is not None else cfg.trainer.max_steps
    metrics = {}
    drop_cfg = cfg.train
    dropping = (drop_cfg.random_drop_context_views
                or drop_cfg.random_drop_target_views)

    # Validation scene source: one scene every val_check_interval steps.
    # Without a `val` split validation is off; never fatal.
    val_example = None
    if cfg.trainer.val_check_interval and rank == 0:
        try:
            val_ds = ChunkedSceneDataset(
                entries[0].dataset,
                make_sampler_for_entry(entries[0], "val"),
                stage="val",
                seed=cfg.trainer.seed,
            )
            val_example = next(iter(val_ds.epoch(0, global_step=0)))
        except (StopIteration, FileNotFoundError, OSError) as e:
            print(f"validation disabled (no val split): {e}", flush=True)

    # --- the memory guard: fit the microbatch before the first step ----
    image_shape = tuple(cfg.image_shape)
    loss_kwargs = dict(image_shape=image_shape, decoder_cfg=cfg.decoder,
                       loss_cfg=cfg.loss, lpips=lpips,
                       training_context=cfg.train.training_context)
    # The guard probes the first step that will run.
    distilling = distiller is not None and start_step <= cfg.train.distill_max_steps
    probe_kwargs = {**loss_kwargs, "distiller": distiller if distilling else None}
    probe_batch = first
    if dropping:
        probe_batch = random_drop_views(first, np.random.default_rng(0),
                                        drop_cfg)
    probe_dev = to_device(probe_batch, device)
    eff_batch = int(probe_batch["context"]["image"].shape[0])
    budget_gb = cfg.trainer.hbm_budget_gb
    if budget_gb is None:
        budget_gb = device_memory_gb(device)
    probes = []

    def probe(mb):
        probes.append({"microbatch": mb, "peak_gb": probe_peak_gb(
            state, probe_dev, mb, probe_kwargs)})
        return probes[-1]["peak_gb"]

    t_guard = time.perf_counter()
    microbatch, peak_gb = fit_microbatch(
        probe, eff_batch, cfg.trainer.microbatch or None, budget_gb)
    if world > 1:
        microbatch = agree_microbatch(microbatch or eff_batch, device)
    guard = {"microbatch": microbatch or eff_batch, "peak_gb": peak_gb,
             "budget_gb": budget_gb, "probes": probes,
             "seconds": time.perf_counter() - t_guard}
    del probe_dev
    run_step = make_train_step(
        encoder, optimizer, image_shape, cfg.decoder, cfg.loss, lpips,
        training_context=cfg.train.training_context, microbatch=microbatch,
        mesh=mesh)
    distill_step = None
    if distiller is not None:
        distill_step = make_train_step(
            encoder, optimizer, image_shape, cfg.decoder, cfg.loss, lpips,
            training_context=cfg.train.training_context, distiller=distiller,
            microbatch=microbatch, mesh=mesh)

    batch = first
    t_start = time.perf_counter()
    for step in range(start_step, total):
        state_holder["step"] = step
        if dropping:
            batch = random_drop_views(batch, rng, drop_cfg)
        fn = (distill_step if distill_step is not None
              and step <= cfg.train.distill_max_steps else run_step)
        state, metrics = fn(state, to_device(batch, device))
        if world > 1:
            print(f"[rank {rank}/{world}] step {step} scenes {batch['scene']}",
                  flush=True)
        if (log_fn is not None and rank == 0
                and step % cfg.train.print_log_every_n_steps == 0):
            logged = {k: float(v) for k, v in metrics.items()}
            if peak_gb is not None:
                logged["mem/peak_hbm_gb"] = peak_gb
            logged["time/data_wait_ms"] = wait_ms
            log_fn(step, logged)
        if (
            val_example is not None
            and step > 0
            and step % cfg.trainer.val_check_interval == 0
        ):
            from spfsplatv2_tpu_torch.training.validation import (
                run_validation_step,
            )

            val_metrics = run_validation_step(
                encoder,
                val_example,
                image_shape,
                decoder_cfg=cfg.decoder,
                lpips=lpips,
                lpips_calibrated=lpips_calibrated,
                out_dir=cfg.output_dir,
                step=step,
            )
            print(
                f"[val @ {step}] "
                + " ".join(f"{k.split('/', 1)[1]}={v:.4g}"
                           for k, v in sorted(val_metrics.items())),
                flush=True,
            )
            if log_fn is not None:
                log_fn(step, val_metrics)
        if (
            cfg.checkpointing.every_n_train_steps
            and step > 0
            and step % cfg.checkpointing.every_n_train_steps == 0
        ):
            save_checkpoint(ckpt_dir, state, step)
        if step + 1 < total:
            t0 = time.perf_counter()
            batch = next(batches)
            wait_ms = (time.perf_counter() - t0) * 1e3

    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["time/steps_per_s"] = (
        (total - start_step) / (time.perf_counter() - t_start)
    )
    return {"state": state, "metrics": metrics, "encoder": encoder,
            "guard": guard, "world": world, "rank": rank}


def _read_state_dict(path: str) -> dict:
    """A torch checkpoint file's weights: its "model" or "state_dict"
    entry when it has one (the file is unpickled in full, as JAX does:
    MASt3R's holds its training arguments beside the weights)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("model", sd.get("state_dict", sd))


def load_pretrained_weights(encoder: torch.nn.Module, encoder_cfg,
                            path: str) -> torch.nn.Module:
    """Load a MASt3R / SPFSplat checkpoint into a CroCo encoder in place
    (`utils/ckpt_convert.py`); what the file lacks keeps its seeded init."""
    from spfsplatv2_tpu_torch.utils.ckpt_convert import (
        convert_spfsplat_checkpoint,
        merge_params,
    )

    if encoder_cfg.name == "spfsplatv2l":
        raise ValueError(
            f"checkpointing.pretrained_weights takes a MASt3R or SPFSplat "
            f"checkpoint of a CroCo encoder; encoder.name={encoder_cfg.name} "
            f"has none (see utils/ckpt_convert_vggt.py for VGGT weights)")
    bb = encoder_cfg.variant_cfg.backbone
    converted = convert_spfsplat_checkpoint(
        _read_state_dict(path), enc_depth=bb.enc_depth,
        dec_depth=bb.dec_depth, patch_hw=(bb.patch_size, bb.patch_size))
    return merge_params(encoder, converted)


def load_distiller_params(weights_path: Optional[str], seed: int,
                          device: str | torch.device,
                          cfg: DistillerConfig = DistillerConfig()
                          ) -> Dust3RDistiller:
    """The frozen DUSt3R teacher: seeded, then (given a checkpoint file)
    DUSt3R / MASt3R weights converted over it."""
    from spfsplatv2_tpu_torch.utils.ckpt_convert import (
        convert_dust3r_distiller_checkpoint,
        merge_params,
    )

    distiller = build_distiller(cfg, seed=seed, device=device)
    if weights_path:
        bb = cfg.backbone
        merge_params(distiller, convert_dust3r_distiller_checkpoint(
            _read_state_dict(weights_path), enc_depth=bb.enc_depth,
            dec_depth=bb.dec_depth, patch_hw=(bb.patch_size, bb.patch_size)))
    return distiller


def checkpoint_dict(state: TrainState) -> dict:
    """The checkpoint of `state`: plain tensors (on their devices; saving
    copies one at a time to the host) and ints.  AdamW's moments are
    keyed by parameter name; a state that never applied an update has
    none."""
    names = {id(p): n for n, p in state.encoder.named_parameters()}
    opt = state.optimizer
    mu, nu = {}, {}
    for p in opt.params:
        s = opt.adamw.state.get(p)
        if s:
            mu[names[id(p)]] = s["exp_avg"]
            nu[names[id(p)]] = s["exp_avg_sq"]
    return {"step": int(state.step), "count": int(opt.count),
            "skipped_count": int(opt.skipped_count),
            "encoder": state.encoder.state_dict(), "mu": mu, "nu": nu}


def save_checkpoint(ckpt_dir: Path, state: TrainState, step: int) -> Path:
    """Write `state` to `<ckpt_dir>/step_<step>/state.pt`; returns the file.

    `torch.save` copies one tensor at a time to the host, so a full-width
    state (~7.3 GB) never has a second copy in host memory.  The file is
    written under a temporary name and renamed.  Under a process group of
    several ranks, rank 0 writes (the replicas are identical) and every
    rank waits for it at a barrier.
    """
    path = Path(ckpt_dir).absolute() / f"step_{step}"
    world, rank = world_rank()
    if rank == 0:
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (CHECKPOINT_FILE + ".tmp")
        torch.save(checkpoint_dict(state), tmp)
        os.replace(tmp, path / CHECKPOINT_FILE)
    if world > 1:
        dist.barrier()
    return path / CHECKPOINT_FILE


def load_checkpoint(path: str | Path) -> dict:
    """Read a `step_<n>/` checkpoint directory memory-mapped: tensors are
    paged in from the file when they are used, so reading only the
    encoder's weights does not read the moments."""
    return torch.load(resolve_checkpoint_uri(path) / CHECKPOINT_FILE,
                      map_location="cpu", weights_only=True, mmap=True)


def restore_state(state: TrainState, ckpt: dict) -> TrainState:
    """Load a checkpoint dict into `state` in place (weights, AdamW
    moments and counts, exactly)."""
    state.encoder.load_state_dict(ckpt["encoder"], strict=True)
    opt = state.optimizer
    named = dict(state.encoder.named_parameters())
    opt.adamw.state.clear()
    with torch.no_grad():
        for name, m in ckpt["mu"].items():
            p = named[name]
            opt.adamw.state[p] = {
                "step": torch.tensor(float(ckpt["count"]), dtype=torch.float32),
                "exp_avg": m.to(p.device, p.dtype, copy=True),
                "exp_avg_sq": ckpt["nu"][name].to(p.device, p.dtype, copy=True),
            }
    opt.count = int(ckpt["count"])
    opt.skipped_count = int(ckpt["skipped_count"])
    state.step = int(ckpt["step"])
    return state


def latest_checkpoint(ckpt_dir: Path) -> Path | None:
    """The newest `step_*` checkpoint directory under `ckpt_dir`, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_"):
            try:
                steps.append((int(p.name.split("_", 1)[1]), p))
            except ValueError:
                continue
    return max(steps)[1] if steps else None


def restore_latest_checkpoint(ckpt_dir: Path, state: TrainState):
    """Resume support: restore the newest `step_*` checkpoint into
    `state`.  Returns (state, next_step) or None when there is none."""
    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        return None
    state = restore_state(state, load_checkpoint(latest))
    return state, int(state.step)


def resolve_checkpoint_uri(path: str | Path) -> Path:
    """Resolve `wandb://run_id[:version]` checkpoint URIs to a local path.

    Artifact `model-<run_id>:<version|latest>` is downloaded into a local
    cache directory, which is then the checkpoint.  Requires the `wandb`
    package and login; plain paths pass through untouched.
    """
    path = str(path)
    if not path.startswith("wandb://"):
        return Path(path)
    spec = path[len("wandb://"):]
    run_id, _, version = spec.partition(":")
    version = version or "latest"
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError(
            f"checkpoint URI {path!r} needs the `wandb` package"
        ) from e
    api = wandb.Api()
    artifact = api.artifact(f"model-{run_id}:{version}")
    root = Path("checkpoints") / "wandb" / f"{run_id}_{version}"
    artifact.download(root=str(root))
    return root
