"""PyTorch port's rasterizer vs the JAX package on the CPU.

K3 (`cumsum_1d`), the projection, the prefix binning and K1's plain
version are held against the JAX functions on the same numpy inputs; the
JAX Pallas kernels run in interpret mode, as the JAX tests run them.  The
CUDA kernels themselves are held against their plain versions in
test_torch_kernels.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.ops import raster_pallas as jpal
from spfsplatv2_tpu.ops import raster_tiled as jtiled
from spfsplatv2_tpu.ops.covariance import build_covariance as jbuild_cov
from spfsplatv2_tpu.ops.raster_common import project_gaussians as jproject
from spfsplatv2_tpu.ops.raster_ref import composite_reference as jreference
from spfsplatv2_tpu.ops.segscan import cumsum_1d as jcumsum
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.covariance import build_covariance
from spfsplatv2_tpu_torch.ops.raster_common import (
    ProjectedGaussians,
    project_gaussians,
)
from spfsplatv2_tpu_torch.ops.raster_cuda import composite_prefix
from spfsplatv2_tpu_torch.ops.raster_ref import composite_reference
from spfsplatv2_tpu_torch.ops.raster_tiled import PrefixBins, bin_gaussians_prefix
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig, render
from spfsplatv2_tpu_torch.ops.segscan import cumsum_1d

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    assert_images_close,
    np_scene,
    to_torch,
)

HW = (48, 48)
BG = np.asarray([0.15, 0.25, 0.35], np.float32)


def projected_pair(seed=0, n=150, hw=HW, cov_scale=1.0):
    """The same scene projected by JAX and by the port."""
    means, scales, quats, harm, op = np_scene(seed, n, cov_scale=cov_scale)
    covs = np.asarray(jbuild_cov(scales, quats))
    eye = np.eye(4, dtype=np.float32)
    jp = jproject(means, covs, harm, op, eye, CAMERA_K, hw)
    tp = project_gaussians(*map(to_torch, (means, covs, harm, op, eye,
                                           CAMERA_K)), hw)
    return jp, tp


def torch_proj(jp) -> ProjectedGaussians:
    return ProjectedGaussians(*[to_torch(x) for x in jp])


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", [1, 255, 257, 4099])
def test_cumsum_1d_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == "int32":
        x = rng.integers(-5, 20, n).astype(np.int32)
    else:
        x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    ref = np.asarray(jcumsum(jnp.asarray(x), interpret=True))
    out = cumsum_1d(torch.from_numpy(x))
    assert out.dtype == torch.from_numpy(x).dtype
    if dtype == "int32":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        # 1e-6 relative to the running magnitude sum(|x|) the scan carries.
        scale = np.cumsum(np.abs(x))
        assert np.all(np.abs(out.numpy() - ref) <= 1e-6 * scale)


def test_project_gaussians_matches_jax():
    jp, tp = projected_pair(seed=1, n=300)
    for name in ("xy", "conic", "color", "opacity"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth),
                               rtol=1e-5)
    for name in ("radius", "rx", "ry"):
        a = getattr(tp, name)
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)


def test_build_covariance_matches_jax():
    _, scales, quats, _, _ = np_scene(2, 64)
    np.testing.assert_allclose(
        build_covariance(to_torch(scales), to_torch(quats)).numpy(),
        np.asarray(jbuild_cov(scales, quats)), rtol=1e-5, atol=1e-7,
    )


BIN_CASES = {
    # name: (dup, base, budget, depth_key, pool_factor, cov_scale)
    "rank_single_tier": (16, None, None, "rank", 0.125, 1.0),
    "rank_two_tier": (16, 2, None, "rank", 0.125, 4.0),
    "quantized": (16, 4, None, "quantized", 0.125, 1.0),
    "tight_budget": (16, 4, 128, "rank", 0.125, 1.0),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_gaussians_prefix_matches_jax(case):
    dup, base, budget, depth_key, pool, cov_scale = BIN_CASES[case]
    jp, _ = projected_pair(seed=3, n=200, cov_scale=cov_scale)
    g = jp.xy.shape[0]
    budget = g * dup if budget is None else budget
    chunk = 64
    jb = jtiled.bin_gaussians_prefix(jp, HW, dup, chunk, budget,
                                     base_tiles_per_gaussian=base,
                                     big_pool_factor=pool, depth_key=depth_key,
                                     interpret=True)
    tb = bin_gaussians_prefix(torch_proj(jp), HW, dup, chunk, budget,
                              base_tiles_per_gaussian=base,
                              big_pool_factor=pool, depth_key=depth_key)
    assert tb.e_pad == jb.e_pad and tb.dup == jb.dup
    assert tb.num_tiles_xy == jb.num_tiles_xy
    for name in ("counts", "starts", "n_live", "n_overflow", "live_counts",
                 "ends", "has_drops", "src_sorted"):
        t, j = getattr(tb, name), np.asarray(getattr(jb, name))
        if t.dtype != torch.bool:
            assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    n_live = int(tb.n_live)
    if case == "tight_budget":
        assert bool(tb.has_drops) and int(tb.n_overflow) > 0
    if depth_key == "rank":
        # Live keys are unique, so the live prefix is fully determined.
        for name in ("flat", "src"):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy()[:n_live],
                np.asarray(getattr(jb, name))[:n_live], err_msg=name)
    else:
        # Quantized keys tie; unstable sorts order ties arbitrarily, so
        # compare each tile's segment as a multiset.
        for s, c in zip(tb.starts.tolist(), tb.counts.tolist()):
            for name in ("flat", "src"):
                np.testing.assert_array_equal(
                    np.sort(getattr(tb, name).numpy()[s:s + c]),
                    np.sort(np.asarray(getattr(jb, name))[s:s + c]))
    # src_order permutes the (clamped) source stream into src_sorted.
    pos = torch.arange(tb.e_pad)
    stream = torch.where(pos < n_live, torch.clamp(tb.src, max=g), g)
    np.testing.assert_array_equal(stream[tb.src_order.long()].numpy(),
                                  tb.src_sorted.numpy())


def test_pool_exhaustion_counts_overflow():
    # A pool far smaller than the number of big gaussians must surface the
    # unmaterialized tiles in n_overflow.
    jp, _ = projected_pair(seed=9, n=150, cov_scale=25.0)
    tp = torch_proj(jp)
    full = bin_gaussians_prefix(tp, HW, 32, 64, 150 * 32,
                                base_tiles_per_gaussian=2, big_pool_factor=1.0)
    tiny = bin_gaussians_prefix(tp, HW, 32, 64, 150 * 32,
                                base_tiles_per_gaussian=2, big_pool_factor=0.0)
    lost = int(full.n_live) - int(tiny.n_live)
    assert lost > 0, "test scene must exhaust the pool"
    assert int(tiny.n_overflow) - int(full.n_overflow) == lost


def _jax_and_plain(jp, hw, dup=32, base=None, chunk=64):
    g = jp.xy.shape[0]
    jb = jtiled.bin_gaussians_prefix(jp, hw, dup, chunk, g * dup,
                                     base_tiles_per_gaussian=base,
                                     interpret=True)
    pal = jpal.composite_pallas_prefix(jp, jb, hw, jnp.asarray(BG),
                                       chunk=chunk, interpret=True)
    ref = jreference(jp, hw, jnp.asarray(BG))
    bins = PrefixBins(*[to_torch(x) if hasattr(x, "shape") else x for x in jb])
    ours = composite_prefix(torch_proj(jp), bins, hw, to_torch(BG), chunk=chunk)
    return ours, pal, ref


@pytest.mark.parametrize("base", [None, 2])
def test_plain_composite_matches_jax_kernel_and_oracle(base):
    jp, _ = projected_pair(seed=0, n=150)
    ours, pal, ref = _jax_and_plain(jp, HW, base=base)
    for desired in (pal, ref):
        assert_images_close(ours[0].numpy(), desired[0], atol=3e-5)   # color
        assert_images_close(ours[1].numpy(), desired[1], atol=3e-4,
                            hard_atol=2e-2)                           # depth
        assert_images_close(ours[2].numpy(), desired[2], atol=3e-5)   # alpha


def test_plain_composite_empty_tiles():
    # Scene confined to one corner: most tiles have zero entries.
    means = np.asarray([[-0.6, -0.6, 2.0]], np.float32)
    covs = np.eye(3, dtype=np.float32)[None] * 0.01
    jp = jproject(means, covs, np.ones((1, 3, 1), np.float32),
                  np.asarray([0.9], np.float32), np.eye(4, dtype=np.float32),
                  CAMERA_K, HW)
    ours, pal, ref = _jax_and_plain(jp, HW, dup=16)
    assert_images_close(ours[0].numpy(), ref[0], atol=3e-5)
    assert_images_close(ours[0].numpy(), pal[0], atol=3e-5)


def test_render_prefix_matches_reference_and_counts_no_launches():
    means, scales, quats, harm, op = map(to_torch, np_scene(4, 120, d_sh=4))
    covs = build_covariance(scales, quats)
    c2w = torch.eye(4)[None].repeat(2, 1, 1)
    c2w[1, 0, 3] = 0.1
    k = to_torch(CAMERA_K)[None].expand(2, 3, 3)
    near, far = torch.full((2,), 0.5), torch.full((2,), 100.0)
    bg = to_torch(BG)[None].expand(2, 3)
    cuda_lib.reset_launch_counts()
    outs = {}
    for backend in ("prefix", "reference"):
        cfg = RasterizerConfig(backend=backend, entry_budget_factor=4.0)
        with torch.no_grad():
            outs[backend] = render(c2w, k, near, far, (32, 32), bg, means * 2,
                                   covs, harm, op, cfg=cfg)
    assert outs["prefix"].dropped_entries.tolist() == [0, 0]
    assert_images_close(outs["prefix"].color, outs["reference"].color, atol=3e-5)
    # On CPU tensors the wrappers take the plain versions: no launch.
    assert not any(cuda_lib.launches().values())

