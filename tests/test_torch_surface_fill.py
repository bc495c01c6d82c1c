"""The port's copies of the JAX package's small names on the CPU: the
bounds and patch shims, `matrix_to_rotation_6d`, `relative_pose`,
`Gaussians.astype` and `concatenate`, `global_view_mask`,
`Benchmarker.clear`, `FreezeConfig.any` and
`CrocoBackboneConfig.num_extra_tokens`, each held against the JAX
function on the same numpy inputs (they are numpy or elementwise
copies: 1e-6 relative, or exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu import gaussians as jgaussians
from spfsplatv2_tpu.data import shims as jshims
from spfsplatv2_tpu.evaluation.benchmarker import Benchmarker as JBenchmarker
from spfsplatv2_tpu.geometry import se3 as jse3
from spfsplatv2_tpu.models.croco.backbone import (
    CrocoBackboneConfig as JCrocoBackboneConfig,
)
from spfsplatv2_tpu.models.vggt.aggregator import (
    global_view_mask as jglobal_view_mask,
)
from spfsplatv2_tpu.training.optim import FreezeConfig as JFreezeConfig
from spfsplatv2_tpu_torch import gaussians
from spfsplatv2_tpu_torch.data import shims
from spfsplatv2_tpu_torch.evaluation.benchmarker import Benchmarker
from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
from spfsplatv2_tpu_torch.models.vggt.aggregator import global_view_mask
from spfsplatv2_tpu_torch.training.optim import FreezeConfig


def rotations(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return np.array(jse3.quaternion_to_matrix(q))


def poses(rng, n):
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    m[:, :3, :3] = rotations(rng, n)
    m[:, :3, 3] = rng.uniform(-2, 2, (n, 3))
    return m


def example(rng, v=2, h=34, w=38):
    intr = np.tile(np.asarray([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]],
                              np.float32), (v, 1, 1))
    intr[:, 0, 0] += rng.uniform(-0.1, 0.1, v).astype(np.float32)
    views = {"image": rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32),
             "intrinsics": intr, "extrinsics": poses(rng, v),
             "near": np.ones((v,), np.float32),
             "far": np.full((v,), 100.0, np.float32)}
    return {"context": views,
            "target": {k: x[:1].copy() for k, x in views.items()}}


@pytest.mark.parametrize("disparity", [0.5, 3.0, 32.0])
def test_compute_depth_for_disparity_matches_jax(disparity):
    rng = np.random.default_rng(1)
    ex = example(rng, v=3)["context"]
    args = (ex["extrinsics"], ex["intrinsics"], (34, 38), disparity)
    ours = shims.compute_depth_for_disparity(*args)
    np.testing.assert_allclose(ours, jshims.compute_depth_for_disparity(*args),
                               rtol=1e-6)
    # All cameras at one point: the baseline floor delta_min.
    ex["extrinsics"][:, :3, 3] = 0.0
    assert shims.compute_depth_for_disparity(*args) == pytest.approx(
        jshims.compute_depth_for_disparity(*args), rel=1e-6)


def test_apply_bounds_shim_matches_jax():
    ex = example(np.random.default_rng(2))
    ours = shims.apply_bounds_shim(ex, near_disparity=3.0, far_disparity=0.5)
    ref = jshims.apply_bounds_shim(ex, near_disparity=3.0, far_disparity=0.5)
    for side in ("context", "target"):
        for key in ("near", "far"):
            assert ours[side][key].dtype == np.float32
            np.testing.assert_allclose(ours[side][key], ref[side][key],
                                       rtol=1e-6)
        np.testing.assert_array_equal(ours[side]["image"], ref[side]["image"])
    assert float(ours["context"]["near"][0]) < float(ours["context"]["far"][0])
    assert ex["context"]["near"][0] == 1.0          # the input is untouched


@pytest.mark.parametrize("hw,patch", [((34, 38), 16), ((64, 48), 14)])
def test_apply_patch_shim_matches_jax(hw, patch):
    ex = example(np.random.default_rng(3), h=hw[0], w=hw[1])
    ours = shims.apply_patch_shim(ex, patch)
    ref = jshims.apply_patch_shim(ex, patch)
    for side in ("context", "target"):
        assert ours[side]["image"].shape[1] % patch == 0
        assert ours[side]["image"].shape[2] % patch == 0
        np.testing.assert_array_equal(ours[side]["image"], ref[side]["image"])
        np.testing.assert_allclose(ours[side]["intrinsics"],
                                   ref[side]["intrinsics"], rtol=1e-6)


def test_matrix_to_rotation_6d_matches_jax_and_inverts():
    r = rotations(np.random.default_rng(4), 64).reshape(4, 16, 3, 3)
    d6 = se3.matrix_to_rotation_6d(torch.from_numpy(r))
    assert d6.shape == (4, 16, 6)
    np.testing.assert_array_equal(d6.numpy(),
                                  np.asarray(jse3.matrix_to_rotation_6d(r)))
    np.testing.assert_allclose(se3.rotation_6d_to_matrix(d6).numpy(), r,
                               atol=1e-6)


def test_relative_pose_matches_jax():
    rng = np.random.default_rng(5)
    a, b = poses(rng, 8), poses(rng, 8)
    np.testing.assert_allclose(
        se3.relative_pose(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jse3.relative_pose(a, b)), rtol=1e-6, atol=1e-6)


def _gaussian_sets(rng, sizes):
    shapes = {"means": (3,), "covariances": (3, 3), "scales": (3,),
              "rotations": (4,), "harmonics": (3, 4), "opacities": ()}
    return [{k: rng.standard_normal((2, g, *s)).astype(np.float32)
             for k, s in shapes.items()} for g in sizes]


@pytest.mark.parametrize("axis", [0, 1])
def test_concatenate_and_astype_match_jax(axis):
    sets = _gaussian_sets(np.random.default_rng(6), (5, 5, 5))
    ours = gaussians.concatenate(
        [gaussians.Gaussians(**{k: torch.from_numpy(x) for k, x in s.items()})
         for s in sets], axis=axis)
    ref = jgaussians.concatenate(
        [jgaussians.Gaussians(**{k: jnp.asarray(x) for k, x in s.items()})
         for s in sets], axis=axis)
    for f in dataclasses.fields(gaussians.Gaussians):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))
    half, jhalf = ours.astype(torch.bfloat16), ref.astype(jnp.bfloat16)
    for f in dataclasses.fields(gaussians.Gaussians):
        t = getattr(half, f.name)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(getattr(jhalf, f.name), np.float32))


@pytest.mark.parametrize("v,p,num_target", [(3, 4, 1), (4, 2, 0), (5, 3, 2)])
def test_global_view_mask_matches_jax(v, p, num_target):
    ours = global_view_mask(v, p, num_target)
    ref = np.asarray(jglobal_view_mask(v, p, num_target))
    assert ours.shape == (v * p, v * p) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
    half = global_view_mask(v, p, num_target, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(half.float().numpy(), ref)


def test_benchmarker_clear():
    ours, ref = Benchmarker("cpu"), JBenchmarker()
    for bench in (ours, ref):
        with bench.time("encoder", num_calls=2):
            pass
        assert bench.summarize()["encoder"]["count"] == 2
        bench.clear()
        assert bench.summarize() == {}
        with bench.time("decoder"):
            pass
    assert set(ours.summarize()) == set(ref.summarize()) == {"decoder"}


@pytest.mark.parametrize("flags", [(False, False, False), (True, False, False),
                                   (False, True, False), (False, False, True),
                                   (True, True, True)])
def test_freeze_config_any_and_extra_tokens_match_jax(flags):
    names = ("freeze_pretrained", "freeze_backbone", "freeze_pose_head")
    kw = dict(zip(names, flags))
    assert FreezeConfig(**kw).any == JFreezeConfig(**kw).any == any(flags)
    tokens = dict(intrinsics_token=flags[0], pose_token=flags[1])
    assert (CrocoBackboneConfig(**tokens).num_extra_tokens
            == JCrocoBackboneConfig(**tokens).num_extra_tokens
            == int(flags[0]) + int(flags[1]))
