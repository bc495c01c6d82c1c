"""Device mesh and data-parallel placement (torch port of
`spfsplatv2_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` with a `data` axis (scenes:
parameters replicated, batches sharded on the leading axis, gradients
all-reduced inside the jitted step) and a `tile` axis (rows of the
rasterized image, `raster_shard.py`).  Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the same two dims, over
the default process group that the caller initialised (`torchrun`
through `main.py`, or `init_process_group` in a test); each process
holds one rank of it.  The gradient all-reduce is DDP's
(`training/step.py`), and `CollectiveAudit` counts what it moves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_data: int | None = None, n_tile: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "tile") mesh over every rank of the default group.

    `n_data` defaults to world size // `n_tile`; n_data * n_tile must be
    the world size.  Raises without an initialised process group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_tile
    if n_data * n_tile != world:
        raise ValueError(f"mesh {n_data} x {n_tile} does not cover the "
                         f"world of {world} ranks")
    return init_device_mesh(device_type, (n_data, n_tile),
                            mesh_dim_names=("data", "tile"))


def batch_sharding(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's slice of the leading (batch) axis: (its `data`
    coordinate, the `data` dim's size)."""
    return mesh.get_local_rank("data"), mesh["data"].size()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's part of every leaf of `batch` along its leading axis.

    The (v,) view masks (`*_valid`) are shared by every example and stay
    whole, as the JAX loop replicates them.  Raises where the leading
    axis does not divide by the `data` dim's size."""
    index, n = batch_sharding(mesh)

    def part(x):
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} does not divide "
                             f"over {n} data ranks")
        size = x.shape[0] // n
        return x[index * size:(index + 1) * size]

    return {k: v if k.endswith("_valid") else _map(part, v)
            for k, v in batch.items()}


def replicate(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from `data` rank 0 to
    the other `data` ranks, in place; returns `module`."""
    group = mesh["data"].get_group()
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src, group=group)
    return module


class CollectiveAudit:
    """A DDP communication hook that counts the gradient all-reduces and
    their bytes, then runs DDP's default all-reduce (the mean over the
    group).

    The claim the JAX package checks in compiled HLO
    (`audit_collectives`): one step moves the trainable parameters'
    gradients once, so its all-reduce bytes are about the f32 bytes of
    the trainable parameters."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = {"all-reduce": {"count": 0, "bytes": 0}}

    def hook(self, group, bucket):
        from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import (
            allreduce_hook,
        )

        buf = bucket.buffer()
        rec = self.counts["all-reduce"]
        rec["count"] += 1
        rec["bytes"] += buf.numel() * buf.element_size()
        return allreduce_hook(group, bucket)


def audit_overlap(events) -> dict:
    """Whether a gradient all-reduce started before the backward pass
    ended, from `torch.profiler`'s host events of one step (the torch
    view of what the JAX package reads from XLA's schedule).

    Returns the all-reduce calls seen, how many started before the last
    autograd node ended, and "overlapped" when any did."""
    reduces = [e for e in events if "all_reduce" in e.name.lower()
               or "allreduce" in e.name.lower()]
    backward = [e for e in events
                if e.name.startswith("autograd::engine::evaluate_function")]
    if not reduces or not backward:
        return {"all_reduce_calls": len(reduces),
                "backward_nodes": len(backward), "overlapped": None}
    end = max(e.time_range.end for e in backward)
    early = sum(e.time_range.start < end for e in reduces)
    return {"all_reduce_calls": len(reduces), "backward_nodes": len(backward),
            "started_before_backward_end": early, "overlapped": early > 0}
