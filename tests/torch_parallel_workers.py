"""The ranks of tests/test_torch_parallel*.py.

Each function runs in a process that `torch.multiprocessing.spawn`
starts: it joins a 2-rank gloo group over a file store, does its part on
the CPU and `torch.save`s what the test compares into `out_dir`.  This
module imports torch and the port only: the spawned processes never
load JAX.
"""

import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import TINY_BACKBONE, TINY_HEADS  # noqa: E402

HW = (32, 32)


def _join(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def tiny_encoder(state_dict):
    from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu_torch.models.encoder import (
        SPFSplatV2Config,
        SPFSplatV2Encoder,
    )

    enc = SPFSplatV2Encoder(SPFSplatV2Config(
        backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS))
    enc.load_state_dict(state_dict, strict=True)
    return enc


def train_steps(state_dict, batch, opt_cfg, decoder_cfgs, mesh=None):
    """One step of the port's `make_train_step` per decoder config, from
    `state_dict` (LPIPS off): after each, the metrics, the parameters, the
    averaged (clipped) gradients and the step's all-reduce audit."""
    from spfsplatv2_tpu_torch.parallel import shard_batch
    from spfsplatv2_tpu_torch.training.optim import Optimizer
    from spfsplatv2_tpu_torch.training.step import (
        LossConfig,
        init_train_state,
        make_train_step,
    )

    enc = tiny_encoder(state_dict)
    opt = Optimizer(opt_cfg, enc.named_parameters())
    state = init_train_state(enc, opt)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    out = []
    for dcfg in decoder_cfgs:
        step = make_train_step(enc, opt, HW, dcfg, LossConfig(use_lpips=False),
                               mesh=mesh)
        state, metrics = step(state, batch)
        out.append({
            "metrics": metrics,
            "params": {k: p.detach().clone()
                       for k, p in enc.named_parameters()},
            "grads": {k: p.grad.detach().clone()
                      for k, p in enc.named_parameters()},
            "audit": None if step.audit is None else step.audit.counts,
        })
    return out


def train_step_rank(rank, world, store, out_dir, state_dict, batch, opt_cfg,
                    decoder_cfgs):
    """`train_steps` on a ("data",) mesh of both ranks, each on its half
    of `batch`; `reduce_metrics` on rank-dependent numbers; and
    `replicate` of an encoder that rank 1 perturbed."""
    from spfsplatv2_tpu_torch.parallel import make_mesh, replicate
    from spfsplatv2_tpu_torch.training.step import reduce_metrics

    _join(rank, world, store)
    mesh = make_mesh(n_data=world, device_type="cpu")
    enc = tiny_encoder(state_dict)
    if rank == 1:
        with torch.no_grad():
            for p in enc.parameters():
                p.add_(1.0)
    replicate(enc, mesh)
    out = {"steps": train_steps(state_dict, batch, opt_cfg, decoder_cfgs,
                                mesh),
           "reduced": reduce_metrics({"f": float(rank), "n": rank + 1},
                                     mesh["data"].get_group(), "cpu"),
           "replicated": all(torch.equal(enc.state_dict()[k], v)
                             for k, v in state_dict.items())}
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def tile_render_rank(rank, world, store, out_dir, scene, cams, cfgs, weights):
    """`render_tile_sharded` on a (1, world) mesh for each rasterizer
    config in `cfgs`, and the gradients of a weighted sum of its outputs
    with respect to the Gaussians."""
    from spfsplatv2_tpu_torch.parallel import make_mesh
    from spfsplatv2_tpu_torch.parallel.raster_shard import render_tile_sharded

    _join(rank, world, store)
    mesh = make_mesh(n_data=1, n_tile=world, device_type="cpu")
    out = {}
    for name, cfg in cfgs.items():
        leaves = [t.clone().requires_grad_(True) for t in scene]
        res = render_tile_sharded(mesh, *cams, *leaves, cfg=cfg)
        loss = sum((o * w).sum() for o, w in zip(
            (res.color, res.depth, res.alpha), weights))
        loss.backward()
        out[name] = {"color": res.color.detach(), "depth": res.depth.detach(),
                     "alpha": res.alpha.detach(),
                     "grads": [t.grad for t in leaves]}
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def cli_train_rank(rank, world, port, out_dir, argv, fake_peaks):
    """`main.main(argv)` as `torchrun` would start rank `rank` of `world`
    (its environment variables), with the memory guard's probe reading
    `fake_peaks[rank][microbatch]` GiB; records the (epoch, scene key)
    of each train example this rank read and the microbatch its steps
    were built with."""
    from spfsplatv2_tpu_torch import main
    from spfsplatv2_tpu_torch.data.dataset import ChunkedSceneDataset
    from spfsplatv2_tpu_torch.training import loop

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    seen, built = [], []
    epoch = ChunkedSceneDataset.epoch

    def recording(self, number=0, **kwargs):
        for example in epoch(self, number, **kwargs):
            if self.stage == "train":
                seen.append((number, example["scene"]))
            yield example

    ChunkedSceneDataset.epoch = recording
    loop.probe_peak_gb = lambda state, batch, mb, kw: fake_peaks[rank][mb]
    make_step = loop.make_train_step

    def record(*args, **kwargs):
        built.append(kwargs["microbatch"])
        return make_step(*args, **kwargs)

    loop.make_train_step = record
    rc = main.main(argv)
    torch.save({"rc": rc, "scenes": seen, "microbatch": built,
                "group_left": not dist.is_initialized()},
               Path(out_dir) / f"rank{rank}.pt")
