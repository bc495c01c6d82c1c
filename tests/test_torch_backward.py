"""The port's compositing backward (K2's plain version) and segmented scan
(K4's plain version) vs the JAX package on the CPU.

Gradients through the port's `project_gaussians` + prefix binning +
`composite_prefix` (plain K1/K2, torch autograd around them) are held
against `jax.grad` through JAX's projection + `composite_pallas_prefix`
(Pallas kernels in interpret mode) on the same numpy scene, and against
the dense oracles.  The CUDA kernels themselves are held against these
plain versions in test_torch_kernels.py.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.ops import raster_pallas as jpal
from spfsplatv2_tpu.ops import raster_tiled as jtiled
from spfsplatv2_tpu.ops.covariance import build_covariance as jbuild_cov
from spfsplatv2_tpu.ops.raster_common import project_gaussians as jproject
from spfsplatv2_tpu.ops.raster_ref import composite_reference as jreference
from spfsplatv2_tpu.ops.segscan import segmented_scan_lanes as jsegscan
from spfsplatv2_tpu_torch.ops import cuda_lib, raster_cuda
from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops.raster_cuda import (
    accumulate_rows,
    composite_backward_plain,
    composite_forward_plain,
    composite_prefix,
)
from spfsplatv2_tpu_torch.ops.raster_ref import composite_reference
from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix
from spfsplatv2_tpu_torch.ops.segscan import segmented_scan_lanes

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import CAMERA_K, np_scene, to_torch  # noqa: E402

HW = (48, 48)
NAMES = ("means", "covs", "harmonics", "opacity", "pose")


def scene(seed, n=100, d_sh=4, cov_scale=1.0):
    means, scales, quats, harm, op = np_scene(seed, n, d_sh=d_sh,
                                              cov_scale=cov_scale)
    covs = np.asarray(jbuild_cov(scales, quats))
    return means, covs, harm, op, np.eye(4, dtype=np.float32)


def loss_terms(col, dep, alp, target):
    return (((col - target) ** 2).mean() + 0.01 * dep.mean()
            + 0.05 * alp.mean())


def jax_grads(args, target, bg, backend, dup=32, base=None, chunk=64,
              budget=None, hw=HW):
    n = args[0].shape[0]

    def loss(*a):
        p = jproject(*a, CAMERA_K, hw)
        if backend == "ref":
            col, dep, alp = jreference(p, hw, jnp.asarray(bg))
        else:
            b = jtiled.bin_gaussians_prefix(
                p, hw, dup, chunk, budget or n * dup,
                base_tiles_per_gaussian=base, interpret=True)
            col, dep, alp = jpal.composite_pallas_prefix(
                p, b, hw, jnp.asarray(bg), chunk=chunk, interpret=True)
        return loss_terms(col, dep, alp, target)

    return [np.asarray(g) for g in jax.grad(loss, argnums=range(5))(*args)]


def port_grads(args, target, bg, backend="prefix", dup=32, base=None,
               chunk=64, budget=None, hw=HW):
    n = args[0].shape[0]
    ts = [to_torch(a).requires_grad_(True) for a in args]
    p = project_gaussians(*ts, to_torch(CAMERA_K), hw)
    if backend == "ref":
        col, dep, alp = composite_reference(p, hw, to_torch(bg))
    else:
        bins = bin_gaussians_prefix(p, hw, dup, chunk, budget or n * dup,
                                    base_tiles_per_gaussian=base)
        col, dep, alp = composite_prefix(p, bins, hw, to_torch(bg), chunk=chunk)
    loss = loss_terms(col, dep, alp, to_torch(target))
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def assert_grads_close(actual, desired, rel=2e-3):
    for name, a, d in zip(NAMES, actual, desired):
        assert np.isfinite(a).all(), name
        scale = float(np.abs(d).max()) + 1e-12
        np.testing.assert_allclose(a, d, atol=rel * scale + 1e-8, err_msg=name)


@pytest.mark.parametrize("base", [None, 2])
def test_grads_match_jax_vjp_and_oracle(base):
    args = scene(0)
    target = np.random.default_rng(4).uniform(0, 1, (*HW, 3)).astype(np.float32)
    bg = np.zeros(3, np.float32)
    cuda_lib.reset_launch_counts()
    ours = port_grads(args, target, bg, base=base)
    assert not any(cuda_lib.launches().values())
    assert_grads_close(ours, jax_grads(args, target, bg, "pallas", base=base))
    assert_grads_close(ours, port_grads(args, target, bg, "ref"))


def test_grads_at_a_background_match_the_oracle():
    """The T channel's cotangent: the JAX VJP drops it (it only ever sees
    black backgrounds); the port differentiates T_fin * background."""
    args = scene(5)
    target = np.random.default_rng(6).uniform(0, 1, (*HW, 3)).astype(np.float32)
    bg = np.asarray([0.6, 0.3, 0.9], np.float32)
    ours = port_grads(args, target, bg)
    assert_grads_close(ours, port_grads(args, target, bg, "ref"))
    assert_grads_close(ours, jax_grads(args, target, bg, "ref"))


def test_backward_plain_matches_autograd_of_forward_plain():
    """The suffix identity against torch autograd through the forward's
    plain version (an independent derivation), per entry."""
    means, covs, harm, op, eye = map(to_torch, scene(7, n=80))
    p = project_gaussians(means, covs, harm, op, eye, to_torch(CAMERA_K), HW)
    bins = bin_gaussians_prefix(p, HW, 16, 64, 80 * 16)
    packed = torch.cat([p.xy, p.conic, p.color, p.opacity[:, None],
                        torch.nan_to_num(p.depth, posinf=0.0)[:, None]],
                       -1).detach()
    tx = bins.num_tiles_xy[1]
    rows = packed[torch.clamp(bins.src.long(), max=79)].requires_grad_(True)
    slots = torch.arange(bins.e_pad, dtype=torch.int32)
    out = composite_forward_plain(rows, slots, bins.counts, bins.starts, tx, 64)
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal(
        out.shape).astype(np.float32))
    (expect,) = torch.autograd.grad(out, rows, cot)
    got = composite_backward_plain(rows.detach(), slots, bins.counts,
                                   bins.starts, tx, out.detach(), cot, 64)
    live = slots < bins.n_live
    scale = expect[live].abs().amax(0)
    assert torch.all((got - expect)[live].abs() <= 1e-4 * scale + 1e-7)
    assert float(got[~live].abs().max()) == 0.0


def test_early_termination_tails_get_zero():
    """64 opaque Gaussians stacked on one axis: the tail behind the
    T < 1e-4 stop gets exactly zero (unwritten slots are not garbage)."""
    n, hw = 64, (16, 16)
    means = np.concatenate([np.zeros((n, 2)), np.linspace(1, 3, n)[:, None]],
                           -1).astype(np.float32)
    covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 0.05, (n, 3, 3)).copy()
    harm = np.random.default_rng(1).standard_normal((n, 3, 1)).astype(np.float32)
    op = np.full((n,), 0.95, np.float32)
    t = [to_torch(x) for x in (means, covs, harm, op)]
    t[2].requires_grad_(True)
    p = project_gaussians(*t, torch.eye(4), to_torch(CAMERA_K), hw)
    bins = bin_gaussians_prefix(p, hw, 16, 32, n * 16)
    col, _, _ = composite_prefix(p, bins, hw, torch.zeros(3), chunk=32)
    (g,) = torch.autograd.grad(col.sum(), t[2])
    pr = project_gaussians(*[x.detach() for x in t[:2]], t[2],
                           t[3], torch.eye(4), to_torch(CAMERA_K), hw)
    (g_ref,) = torch.autograd.grad(composite_reference(pr, hw, torch.zeros(3))[0]
                                   .sum(), t[2])
    scale = float(g_ref.abs().max())
    assert torch.allclose(g, g_ref, atol=1e-4 * scale + 1e-6)
    assert float(g[-4:].abs().max()) == 0.0


def test_tight_budget_grads_stay_finite_and_take_the_fallback(monkeypatch):
    monkeypatch.setattr(raster_cuda, "ACCUM_MODE", "segscan")
    args = scene(5, n=200)
    target = np.zeros((32, 32, 3), np.float32)
    ts = [to_torch(a).requires_grad_(True) for a in args]
    p = project_gaussians(*ts, to_torch(CAMERA_K), (32, 32))
    bins = bin_gaussians_prefix(p, (32, 32), 16, 32, 128)
    assert bool(bins.has_drops)
    col, _, _ = composite_prefix(p, bins, (32, 32), torch.zeros(3), chunk=32)
    grads = torch.autograd.grad(((col - to_torch(target)) ** 2).sum(), ts)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("n,block", [(256, 256), (1024, 128)])
def test_segmented_scan_matches_jax(n, block):
    rng = np.random.default_rng(n)
    vals = rng.standard_normal((10, n)).astype(np.float32)
    seg = np.sort(rng.integers(0, n // 5, n)).astype(np.int32)
    ref = np.asarray(jsegscan(jnp.asarray(vals), jnp.asarray(seg), block=block,
                              interpret=True))
    out = segmented_scan_lanes(to_torch(vals), to_torch(seg)).numpy()
    # 1e-5 of the running sum of |x| within the segment.
    first = np.searchsorted(seg, seg)
    cs = np.cumsum(np.abs(vals), 1)
    scale = cs - np.where(first > 0, cs[:, np.maximum(first - 1, 0)], 0.0)
    assert np.all(np.abs(out - ref) <= 1e-5 * scale + 1e-7)


def test_segscan_accumulation_equals_segsum(monkeypatch):
    means, covs, harm, op, eye = map(to_torch, scene(9, n=150, cov_scale=4.0))
    p = project_gaussians(means, covs, harm, op, eye, to_torch(CAMERA_K), HW)
    bins = bin_gaussians_prefix(p, HW, 16, 64, 150 * 16,
                                base_tiles_per_gaussian=2)
    assert not bool(bins.has_drops)
    drows = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (bins.e_pad, 10)).astype(np.float32))
    drows[int(bins.n_live):] = 0.0
    sums = {}
    for mode in ("segsum", "segscan"):
        monkeypatch.setattr(raster_cuda, "ACCUM_MODE", mode)
        sums[mode] = accumulate_rows(drows, bins, 150)
    assert tuple(sums["segsum"].shape) == (150, 10)
    assert float(sums["segsum"].abs().max()) > 0
    torch.testing.assert_close(sums["segscan"], sums["segsum"], rtol=1e-5,
                               atol=1e-5)
