"""Chunked scene dataset: iterates `.torch` chunk files into training
examples (copy of `spfsplatv2_tpu/data/dataset.py`).

One class serves re10k, acid, dl3dv, scannetpp and dtu:
  * a host-side numpy generator; per-host sharding by
    (shard_id, num_shards);
  * the view-sampler gap schedule reads a `global_step` argument (an int
    or a callable read at each example);
  * per-example fault tolerance: FOV filter, baseline range rejection,
    bad-shape and bad-image skipping.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from spfsplatv2_tpu_torch.data import chunk_io
from spfsplatv2_tpu_torch.data.shims import apply_augmentation, apply_crop_shim


@dataclass(frozen=True)
class DatasetConfig:
    roots: tuple[str, ...] = ()
    input_image_shape: tuple[int, int] = (256, 256)
    original_image_shape: tuple[int, int] = (360, 640)
    max_fov: float = 100.0
    make_baseline_1: bool = True
    relative_pose: bool = True
    baseline_min: float = 1e-3
    baseline_max: float = 1e2
    near: float = 1.0
    far: float = 100.0
    augment: bool = True
    skip_bad_shape: bool = True
    overfit_to_scene: Optional[str] = None
    # Parallel example assembly (JPEG decode + shims dominate; PIL releases
    # the GIL inside libjpeg): an ordered thread-pool window, so output
    # order stays deterministic. 0 = fully synchronous.
    num_workers: int = 4


def _fov_deg(intrinsics: np.ndarray) -> np.ndarray:
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    return np.degrees(
        np.stack([2 * np.arctan(0.5 / fx), 2 * np.arctan(0.5 / fy)], -1)
    )


def _camera_normalization(pivot: np.ndarray, poses: np.ndarray) -> np.ndarray:
    return np.linalg.inv(pivot)[None] @ poses


class ChunkedSceneDataset:
    def __init__(
        self,
        cfg: DatasetConfig,
        view_sampler,
        stage: str = "train",
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.view_sampler = view_sampler
        self.stage = stage
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.chunks: list[Path] = []
        for root in cfg.roots:
            root = Path(root) / stage if (Path(root) / stage).exists() else Path(root)
            self.chunks.extend(sorted(root.glob("*.torch")))
        if not self.chunks:
            raise FileNotFoundError(f"no .torch chunks under {cfg.roots}")

    def __iter__(self) -> Iterator[dict]:
        return self.epoch(0)

    def epoch(self, epoch: int = 0, global_step=0) -> Iterator[dict]:
        """Yield processed examples.

        `global_step` may be an int or a 0-arg callable; a callable is read
        at each example submission so curriculum schedules (the view-gap
        warmup, reference StepTracker semantics) advance WITHIN an epoch,
        not only at epoch boundaries.
        """
        cfg = self.cfg
        get_step = global_step if callable(global_step) else (
            lambda: global_step
        )
        rng = np.random.default_rng(
            (self.seed, epoch, self.shard_id) if self.stage == "train" else 0
        )
        chunks = list(self.chunks)
        if self.stage in ("train", "val"):
            # The shards stride one chunk order, drawn from a generator
            # they share, so that they are disjoint.  (The JAX package
            # shuffles with each shard's own generator, so its shards
            # overlap; one shard's stream is the same in both.)
            order = rng if self.num_shards == 1 else np.random.default_rng(
                (self.seed, epoch))
            order.shuffle(chunks)
        # Per-host sharding: stride chunks across shards.
        chunks = chunks[self.shard_id:: self.num_shards]

        def examples():
            for chunk_path in chunks:
                chunk = chunk_io.load_chunk(chunk_path)
                if cfg.overfit_to_scene is not None:
                    matches = [
                        x for x in chunk if x["key"] == cfg.overfit_to_scene
                    ]
                    if not matches:
                        continue
                    chunk = matches * len(chunk)
                if self.stage in ("train", "val"):
                    rng.shuffle(chunk)
                yield from chunk

        if self.cfg.num_workers <= 0:
            # Same per-example child-RNG scheme as the parallel path so the
            # example stream is identical for ANY worker count.
            for example in examples():
                child = np.random.default_rng(rng.integers(0, 2**63))
                out = self._process(example, child, get_step())
                if out is not None:
                    yield out
            return

        # Ordered sliding window over a thread pool: per-example child RNGs
        # are spawned SEQUENTIALLY from the epoch rng (deterministic), the
        # heavy work (decode/shims) runs concurrently, results come back in
        # submission order.
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        window = 4 * self.cfg.num_workers
        pool = ThreadPoolExecutor(
            self.cfg.num_workers, thread_name_prefix="dataset"
        )
        pending: deque = deque()
        try:
            for example in examples():
                child = np.random.default_rng(rng.integers(0, 2**63))
                pending.append(
                    pool.submit(self._process, example, child, get_step())
                )
                while len(pending) >= window:
                    out = pending.popleft().result()
                    if out is not None:
                        yield out
            while pending:
                out = pending.popleft().result()
                if out is not None:
                    yield out
        finally:
            # wait=True: letting decode threads outlive the generator
            # aborts the interpreter at exit (PIL worker in teardown).
            pool.shutdown(wait=True, cancel_futures=True)

    def _process(self, example, rng, global_step) -> Optional[dict]:
        cfg = self.cfg
        extrinsics, intrinsics = chunk_io.decode_poses(example["cameras"])
        scene = example["key"]
        num_views = extrinsics.shape[0]

        try:
            ctx_idx, tgt_idx = self.view_sampler.sample(
                scene, num_views, rng, global_step
            )
        except ValueError:
            return None

        if (_fov_deg(intrinsics) > cfg.max_fov).any():
            return None

        try:
            ctx_images = np.stack(
                [chunk_io.decode_jpeg_u8(example["images"][i]) for i in ctx_idx]
            )
            tgt_images = np.stack(
                [chunk_io.decode_jpeg_u8(example["images"][i]) for i in tgt_idx]
            )
        except (IndexError, OSError):
            return None

        if cfg.skip_bad_shape:
            want = tuple(cfg.original_image_shape)
            if ctx_images.shape[1:3] != want or tgt_images.shape[1:3] != want:
                return None

        # World rescale: context baseline -> 1.
        extrinsics = extrinsics.copy()
        if cfg.make_baseline_1:
            a = extrinsics[ctx_idx[0], :3, 3]
            b = extrinsics[ctx_idx[-1], :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < cfg.baseline_min or scale > cfg.baseline_max:
                return None
            extrinsics[:, :3, 3] /= scale
        else:
            scale = 1.0

        if cfg.relative_pose:
            extrinsics = _camera_normalization(
                extrinsics[ctx_idx[0]], extrinsics
            )

        def views(indices, images):
            n = len(indices)
            return {
                "extrinsics": extrinsics[indices].astype(np.float32),
                "intrinsics": intrinsics[indices].astype(np.float32),
                # uint8 until the crop shim's resample (which emits float
                # [0, 1]); the augmentation flip is dtype-agnostic.
                "image": images,
                "near": np.full((n,), cfg.near / scale, np.float32),
                "far": np.full((n,), cfg.far / scale, np.float32),
                "index": indices,
            }

        out = {
            "context": views(ctx_idx, ctx_images),
            "target": views(tgt_idx, tgt_images),
            "scene": scene,
        }
        # Evaluation indices carry a context-overlap value used for
        # per-overlap score buckets.
        overlap_for = getattr(self.view_sampler, "overlap_for", None)
        if overlap_for is not None:
            overlap = overlap_for(scene)
            if overlap is not None:
                out["context"]["overlap"] = np.float32(overlap)
        if self.stage == "train" and cfg.augment:
            out = apply_augmentation(out, rng)
        return apply_crop_shim(out, tuple(cfg.input_image_shape))


def collate(examples: list[dict]) -> dict:
    """Stack a list of examples into a batched numpy pytree."""
    batch: dict = {"scene": [e["scene"] for e in examples]}
    for side in ("context", "target"):
        batch[side] = {
            k: np.stack([e[side][k] for e in examples])
            for k in examples[0][side]
        }
    return batch


def concat_batches(batches) -> dict:
    """Concatenate collated batches along the batch axis.

    Multi-dataset step assembly: one batch per dataset, concatenated
    every training step.  Only keys present in EVERY batch survive (e.g. `overlap` exists only
    for evaluation-sampler datasets).
    """
    batches = list(batches)
    out: dict = {"scene": [s for b in batches for s in b["scene"]]}
    for side in ("context", "target"):
        shared = set(batches[0][side])
        for b in batches[1:]:
            shared &= set(b[side])
        out[side] = {
            k: np.concatenate([b[side][k] for b in batches])
            for k in sorted(shared)
        }
    return out
