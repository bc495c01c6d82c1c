"""The tile-sharded render and the command line's data-parallel training
on the CPU: two gloo ranks (`tests/torch_parallel_workers.py`).

  * `render_tile_sharded` on a (1, 2) mesh, each rank rendering 32 of
    the 64 rows: on the "tiled" backend against JAX's at
    `make_mesh(n_data=1, n_tile=2)` within JAX's own bounds
    (tests/test_tile_shard.py); on the kernel path ("prefix", the plain
    versions here) against the port's single-device render, outputs and
    the Gaussians' gradients, which a band gradient summed over the
    ranks would make twice too large;
  * `main.main` under `torchrun`'s environment in two processes: each
    rank reads its own chunks, the ranks agree on the smallest
    microbatch, and rank 0's checkpoint loads at world size 1.
"""

import socket
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu.parallel import make_mesh as jmake_mesh
from spfsplatv2_tpu.parallel.raster_shard import (
    render_tile_sharded as jrender_tile_sharded,
)
from spfsplatv2_tpu_torch.data.chunk_io import save_chunk
from spfsplatv2_tpu_torch.data.synthetic import generate_scene
from spfsplatv2_tpu_torch.models import get_encoder
from spfsplatv2_tpu_torch.config import load_config
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig, render
from spfsplatv2_tpu_torch.training.loop import load_checkpoint

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_workers as workers  # noqa: E402
from test_rasterizer import CAMERA_K, make_scene  # noqa: E402
from test_torch_parallel import WORLD, join, spawn  # noqa: E402
from torch_port_common import assert_images_close, cli_overrides  # noqa: E402

H = W = 64
PRESET = str(Path(__file__).resolve().parents[1]
             / "experiments/spfsplatv2/re10k.yaml")


@pytest.fixture(scope="module")
def tile_run(tmp_path_factory):
    """Both ranks' sharded renders and gradients ("tiled" and "prefix"),
    JAX's sharded render and the port's single-device prefix render, on
    JAX's test scene (120 Gaussians, two cameras)."""
    means, covs, harm, op = (np.array(x) for x in make_scene(
        jax.random.PRNGKey(1), n=120, d_sh=1))
    c2w = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    c2w[1, 0, 3] = 0.15
    intr = np.stack([np.asarray(CAMERA_K)] * 2).astype(np.float32)
    near, far = np.ones(2, np.float32), np.full(2, 100.0, np.float32)
    bg = np.zeros((2, 3), np.float32)
    rng = np.random.default_rng(0)
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, H, W, 3), (2, H, W), (2, H, W))]
    scene = [torch.from_numpy(x) for x in (means, covs, harm, op)]
    cams = [torch.from_numpy(x) for x in (c2w, intr, near, far)]
    cams = (*cams, (H, W), torch.from_numpy(bg))
    cfgs = {"tiled": RasterizerConfig(backend="tiled", scale_invariant=False,
                                      max_per_tile=512),
            "prefix": RasterizerConfig(scale_invariant=False)}
    ctx, out = spawn(workers.tile_render_rank, tmp_path_factory.mktemp("tile"),
                     scene, cams, cfgs, weights)
    mesh = jmake_mesh(n_data=1, n_tile=WORLD)
    with mesh:
        jout = jrender_tile_sharded(
            mesh, c2w, intr, near, far, (H, W), bg, means, covs, harm, op,
            cfg=JRasterizerConfig(scale_invariant=False, max_per_tile=512))
    leaves = [t.clone().requires_grad_(True) for t in scene]
    single = render(*cams[:4], (H, W), cams[5], *leaves, cfg=cfgs["prefix"])
    sum((o * w).sum() for o, w in zip(
        (single.color, single.depth, single.alpha), weights)).backward()
    return {"ranks": join(ctx, out), "jax": jout, "single": single,
            "single_grads": [t.grad for t in leaves]}


def test_tile_sharded_render_matches_jax(tile_run):
    """The gathered image on every rank against JAX's sharded render,
    with tests/test_tile_shard.py's bounds."""
    jout = tile_run["jax"]
    for rank in tile_run["ranks"]:
        got = rank["tiled"]
        assert got["color"].shape == (2, H, W, 3)
        assert_images_close(got["color"], np.asarray(jout.color), atol=1e-4)
        assert_images_close(got["alpha"], np.asarray(jout.alpha), atol=1e-4)
        assert_images_close(got["depth"], np.asarray(jout.depth), atol=1e-3,
                            hard_atol=2e-2)


def test_tile_sharded_gradients_match_single_render(tile_run):
    """The kernel path's bands against one render of the whole image:
    outputs within JAX's bounds, and on every rank the Gaussians'
    gradients (each band's, summed over the ranks) within 1e-4 of each
    field's max."""
    single = tile_run["single"]
    for rank in tile_run["ranks"]:
        got = rank["prefix"]
        for name, atol, hard in (("color", 1e-4, 5e-3), ("alpha", 1e-4, 5e-3),
                                 ("depth", 1e-3, 2e-2)):
            assert_images_close(got[name], getattr(single, name).detach(),
                                atol=atol, hard_atol=hard)
        for name, g, want in zip(("means", "covariances", "harmonics",
                                  "opacities"), got["grads"],
                                 tile_run["single_grads"]):
            scale = float(want.abs().max())
            assert scale > 0, name
            np.testing.assert_allclose(g.numpy(), want.numpy(),
                                       atol=1e-4 * scale, err_msg=name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_trains_on_two_ranks(tmp_path):
    """`main.main(--device cpu ...)` with torchrun's variables in two
    processes, 2 steps of b = 2 a rank on four one-scene chunks: rc 0,
    disjoint scene shards in every epoch, both ranks' steps built at the
    smallest microbatch the guard found (rank 1's probe reads over the
    5 GiB budget at 2 and halves), the group left, and rank 0's
    checkpoint loaded into an encoder at world size 1."""
    root = tmp_path / "data"
    (root / "train").mkdir(parents=True)
    for i in range(4):
        save_chunk([generate_scene(f"scene_{i:03d}", 30, (32, 32), 40, i)],
                   root / "train" / f"{i:06d}.torch")
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--config", PRESET] + cli_overrides(root, out, [
        "mode=train", "trainer.max_steps=2", "trainer.batch_size=2",
        "trainer.val_check_interval=0", "checkpointing.every_n_train_steps=0",
        "loss.use_lpips=false", "trainer.hbm_budget_gb=5"])
    peaks = [{2: 1.0, 1: 1.0}, {2: 10.0, 1: 1.0}]
    results = tmp_path / "ranks"
    results.mkdir()
    ctx = mp.spawn(workers.cli_train_rank,
                   args=(WORLD, _free_port(), str(results), argv, peaks),
                   nprocs=WORLD, join=False)
    ranks = join(ctx, results)
    assert [r["rc"] for r in ranks] == [0, 0]
    assert all(r["group_left"] for r in ranks)
    # Each epoch's chunk order is shared by the ranks: within an epoch
    # they read disjoint shards.
    epochs = {e for r in ranks for e, _ in r["scenes"]}
    for e in epochs:
        seen = [{k for n, k in r["scenes"] if n == e} for r in ranks]
        assert seen[0] and seen[1] and not seen[0] & seen[1], (e, seen)
    assert [r["microbatch"] for r in ranks] == [[1], [1]]
    ckpt = load_checkpoint(out / "checkpoints" / "step_-1")
    assert (ckpt["step"], ckpt["count"]) == (2, 2)
    cfg = load_config([PRESET], argv[4:])
    enc = get_encoder(cfg.encoder, device="cpu")
    enc.load_state_dict(ckpt["encoder"], strict=True)
