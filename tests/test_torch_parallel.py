"""The port's data-parallel train step on the CPU: two gloo ranks.

`make_train_step(mesh=make_mesh(n_data=2))` runs in two processes
(`tests/torch_parallel_workers.py`), each on its half of a b = 8 batch of
the tiny encoder (32x32, LPIPS off, the kernels' plain versions), and is
held against:
  * JAX's `make_train_step(mesh=make_mesh(n_data=2))` on two devices of
    the 8-device CPU mesh (conftest.py), its dense reference rasterizer,
    from the same numpy weights: the loss within rtol 2e-4, as
    tests/test_training.py holds JAX's own data-parallel step, and the
    updated parameters within the bar below;
  * the port's one-process step on the whole batch: metrics, averaged
    gradients and parameters;
  * each other: the two replicas bit for bit.
It also holds the reductions of the metrics, the all-reduce audit and
`band_intrinsics` (against JAX).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.ops.raster_common import (
    project_gaussians as jproject_gaussians,
)
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu.parallel import make_mesh as jmake_mesh
from spfsplatv2_tpu.parallel import replicate as jreplicate
from spfsplatv2_tpu.parallel import shard_batch as jshard_batch
from spfsplatv2_tpu.parallel.raster_shard import (
    band_intrinsics as jband_intrinsics,
)
from spfsplatv2_tpu.training import optim as joptim
from spfsplatv2_tpu.training import step as jstep
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.ops.covariance import build_covariance
from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig, render
from spfsplatv2_tpu_torch.parallel.raster_shard import band_intrinsics
from spfsplatv2_tpu_torch.training.optim import OptimizerConfig
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_workers as workers  # noqa: E402
from test_torch_train import make_batch, torch_batch  # noqa: E402
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    jax_tiny_encoder,
    np_scene,
    random_flax_params,
    to_torch,
)

B, WORLD = 8, 2
LR = 1e-4
# One warm-up step: the first update runs at the full rate, so that the
# updated parameters carry the gradient's signs.
OPT = dict(lr=LR, warm_up_steps=1)
# The second step's entry budget, a quarter of the Gaussians, drops
# entries: its counter must come back summed over the ranks.
TIGHT = 0.25


def _decoder(factor):
    return DecoderConfig(rasterizer=RasterizerConfig(
        entry_budget_factor=factor, chunk=64))


def spawn(fn, tmp_path, *args):
    """Start `fn(rank, WORLD, store, out_dir, *args)` in WORLD processes;
    returns the context to join and the directory of their results."""
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.spawn(fn, args=(WORLD, str(tmp_path / "store"), str(out), *args),
                   nprocs=WORLD, join=False)
    return ctx, out


def join(ctx, out) -> list:
    while not ctx.join(timeout=120):
        pass
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The 2-rank step (and a second one at the tight budget), JAX's
    data-parallel step and the port's one-process steps on the same b = 8
    batch and weights."""
    batch = make_batch(0, b=B)
    c, t = batch["context"], batch["target"]
    jenc = jax_tiny_encoder()
    params = random_flax_params(jenc, 5, c["image"][:1], c["intrinsics"][:1],
                                t["image"][:1], t["intrinsics"][:1])
    sd = flax_to_state_dict(params)
    cfgs = [_decoder(4.0), _decoder(TIGHT)]
    ctx, out = spawn(workers.train_step_rank, tmp_path_factory.mktemp("dp"),
                     sd, torch_batch(batch), OptimizerConfig(**OPT), cfgs)
    # JAX and the one-process steps run while the ranks do.
    mesh = jmake_mesh(n_data=WORLD)
    jopt = joptim.make_optimizer(joptim.OptimizerConfig(**OPT), params)
    jfn = jstep.make_train_step(
        jenc, jopt, workers.HW, JDecoderConfig(rasterizer=JRasterizerConfig(
            backend="reference", entry_budget_factor=4.0, chunk=64)),
        jstep.LossConfig(use_lpips=False), donate=False, mesh=mesh)
    jstate, jmetrics = jfn(
        jreplicate(jstep.init_train_state(jenc, jopt, params), mesh),
        jshard_batch(batch, mesh))
    one = workers.train_steps(sd, torch_batch(batch), OptimizerConfig(**OPT),
                              cfgs)
    ranks = join(ctx, out)
    return {"ranks": ranks, "one": one, "before": sd,
            "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
            "jax_params": flax_to_state_dict(jax.device_get(jstate.params))}


def test_dp_step_matches_jax_data_parallel_step(dp_run):
    """Loss within rtol 2e-4 of JAX's; the updated parameters within
    2 * lr of JAX's everywhere and within 1e-2 * lr in 99% of each
    tensor's elements (the pretrained group's rate is lr / 10).  AdamW's
    first update moves an element by lr * g / (|g| + eps), about lr times
    the gradient's sign, so a
    gradient whose sign the two packages' rounding flips (|g| near 0,
    where the port and JAX differ by ~1e-4 of max|g|) moves it by up to
    2 * lr apart; elsewhere the updates agree to rounding."""
    rank0 = dp_run["ranks"][0]["steps"][0]
    np.testing.assert_allclose(rank0["metrics"]["loss/total"],
                               dp_run["jax_metrics"]["loss/total"], rtol=2e-4)
    for name, want in dp_run["jax_params"].items():
        got = rank0["params"][name]
        diff = (got - want).abs()
        moved = (got - dp_run["before"][name]).abs()
        assert float(moved.max()) > 0.05 * LR, name
        assert float(diff.max()) <= 2 * LR, name
        assert float((diff <= 1e-2 * LR).float().mean()) >= 0.99, name


def test_dp_step_matches_one_process_step(dp_run):
    """Two ranks of b = 4 against one process of b = 8: the same metrics
    (the mean of the two halves' means is the whole batch's) and averaged
    gradients within 3e-4 of each tensor's max: float32 sums taken in
    another order (seen: up to 1.2e-4, on `input_merger`'s weight, whose
    gradient is a near-cancelling sum 1e-3 the size of the others)."""
    for i in range(2):
        rank0, one = dp_run["ranks"][0]["steps"][i], dp_run["one"][i]
        assert set(rank0["metrics"]) == set(one["metrics"])
        for key, want in one["metrics"].items():
            np.testing.assert_allclose(rank0["metrics"][key], want, rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {key}")
        for name, want in one["grads"].items():
            scale = float(want.abs().max())
            np.testing.assert_allclose(
                rank0["grads"][name].numpy(), want.numpy(),
                atol=3e-4 * scale + 1e-12, err_msg=f"step {i} {name}")
        assert one["audit"] is None


def test_dp_replicas_stay_bit_identical(dp_run):
    """Every rank applies the same update to the same all-reduced
    gradient: the replicas agree bit for bit after each step.  And
    `replicate` gives rank 1 rank 0's weights."""
    assert all(r["replicated"] for r in dp_run["ranks"])
    r0, r1 = (r["steps"] for r in dp_run["ranks"])
    for a, b in zip(r0, r1):
        for name in a["params"]:
            assert torch.equal(a["params"][name], b["params"][name]), name
            assert torch.equal(a["grads"][name], b["grads"][name]), name
        assert a["metrics"] == b["metrics"]


def test_dp_metrics_averaged_and_counters_summed(dp_run):
    """Float metrics are the ranks' mean and integer counters their sum:
    the tight-budget step's dropped entries (over all 8 cameras) equal
    the one-process step's, and `reduce_metrics` on rank-dependent
    numbers gives their mean and sum."""
    for r in dp_run["ranks"]:
        assert r["reduced"] == {"f": 0.5, "n": 3}
    got = dp_run["ranks"][0]["steps"][1]["metrics"]["raster/dropped_entries"]
    want = dp_run["one"][1]["metrics"]["raster/dropped_entries"]
    assert isinstance(got, int) and got == want > 0
    assert dp_run["ranks"][0]["steps"][0]["metrics"][
        "raster/dropped_entries"] == 0


def test_dp_all_reduce_audit_moves_the_parameters_once(dp_run):
    """One step's all-reduce bytes against the f32 bytes of the
    trainable parameters (the JAX package's audit asserts a ratio in
    [0.9, 3.0]; DDP's buckets hold every gradient once)."""
    param_bytes = sum(t.numel() * 4 for t in dp_run["before"].values())
    for r in dp_run["ranks"]:
        for step in r["steps"]:
            audit = step["audit"]["all-reduce"]
            assert audit["count"] >= 1
            assert 0.9 <= audit["bytes"] / param_bytes <= 3.0
            assert audit["bytes"] == param_bytes


def test_band_intrinsics_matches_jax():
    """A band camera's intrinsics, and its projection of a scene with the
    full image as the EWA reference, against JAX's."""
    h = w = 64
    band_h, off = 16, 32
    means, scales, quats, harm, op = np_scene(0, n=40, d_sh=1)
    covs = build_covariance(to_torch(scales), to_torch(quats)).numpy()
    k_band = band_intrinsics(to_torch(CAMERA_K), off, band_h, h)
    jk_band = np.asarray(jband_intrinsics(jax.numpy.asarray(CAMERA_K), off,
                                          band_h, h))
    np.testing.assert_allclose(k_band.numpy(), jk_band, rtol=1e-7)
    band = project_gaussians(to_torch(means), to_torch(covs), to_torch(harm),
                             to_torch(op), torch.eye(4), k_band, (band_h, w),
                             ewa_reference_shape=(h, w))
    jband = jproject_gaussians(means, covs, harm, op,
                               np.eye(4, dtype=np.float32), jk_band,
                               (band_h, w), ewa_reference_shape=(h, w))
    for field in ("xy", "conic", "opacity"):
        np.testing.assert_allclose(getattr(band, field).numpy(),
                                   np.asarray(getattr(jband, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    full = project_gaussians(to_torch(means), to_torch(covs), to_torch(harm),
                             to_torch(op), torch.eye(4), to_torch(CAMERA_K),
                             (h, w))
    np.testing.assert_allclose(band.xy[:, 1], full.xy[:, 1] - off, atol=1e-3)
    np.testing.assert_allclose(band.conic, full.conic, rtol=1e-4)


def test_band_render_keeps_the_full_images_depth_order():
    """Under the quantized depth key the key's depth bits depend on the
    tile count; a band rendered with the full image as its reference keeps
    the full image's bits and reproduces its rows.  Pairs of overlapping
    Gaussians tie at the full 64x64 image's bits (16 tiles: 26 depth
    bits) but not at a 32-row band's own (8 tiles: 27), the farther one
    listed first, so the full render's tie order (by index) is the
    reverse of the band's own depth order."""
    h = w = 64
    band_h = 32
    rng = np.random.default_rng(3)
    n = 24
    k = (np.float32(3.0).view(np.int32) >> 5) + rng.integers(0, 4000, n)
    near_z = (k.astype(np.int32) << 5).view(np.float32)
    far_z = ((k.astype(np.int32) << 5) + 16).view(np.float32)
    xy = rng.uniform(-0.4, 0.4, (n, 2)).astype(np.float32)
    xy[:, 1] = rng.uniform(-0.45, -0.05, n)          # in rows 0-31
    means = np.concatenate([
        np.concatenate([xy * z[:, None], z[:, None]], 1)
        for z in (far_z, near_z)])
    scales = np.full((2 * n, 3), 0.08, np.float32)
    quats = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (2 * n, 1))
    harm = np.zeros((2 * n, 3, 1), np.float32)
    harm[:n, 0, 0], harm[n:, 1, 0] = 1.5, 1.5           # far red, near green
    op = np.full(2 * n, 0.8, np.float32)
    covs = build_covariance(to_torch(scales), to_torch(quats))
    scene = (to_torch(means.astype(np.float32)), covs, to_torch(harm),
             to_torch(op))
    cfg = RasterizerConfig(scale_invariant=False, depth_key="quantized")
    cam = (torch.eye(4)[None], to_torch(CAMERA_K)[None], torch.ones(1),
           torch.full((1,), 100.0))
    bg = torch.zeros(1, 3)
    full = render(*cam, (h, w), bg, *scene, cfg=cfg)
    k_band = band_intrinsics(to_torch(CAMERA_K), 0, band_h, h)[None]
    band = render(cam[0], k_band, *cam[2:], (band_h, w), bg, *scene, cfg=cfg,
                  ewa_reference_shape=(h, w))
    own = render(cam[0], k_band, *cam[2:], (band_h, w), bg, *scene, cfg=cfg)
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(band, name).numpy(),
                                   getattr(full, name)[:, :band_h].numpy(),
                                   atol=1e-5, err_msg=name)
    # The band's own bits order the ties by depth: other colours.
    assert float((own.color - full.color[:, :band_h]).abs().max()) > 0.1
