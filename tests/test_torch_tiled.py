"""The port's "tiled" render backend vs the JAX package's on the CPU, and
`render`'s per-camera rescale.

The "tiled" backend is plain torch in the port and plain XLA in JAX (no
kernel on either side): the same numpy scene goes through both
`render(..., backend="tiled")`, square and ragged (96 x 64: a half tile
at the bottom edge), and with a small `max_per_tile` that drops entries;
images, dropped counts and the gradients of a weighted loss with respect
to the means, the opacities and the camera pose are compared.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.ops import raster_tiled as jtiled
from spfsplatv2_tpu.ops.covariance import build_covariance as jbuild_cov
from spfsplatv2_tpu.ops.raster_common import project_gaussians as jproject
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu.ops.rasterizer import render as jrender
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians, rasterize_tiled
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig, render

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    assert_images_close,
    np_scene,
    to_torch,
)

BG = np.asarray([0.15, 0.25, 0.35], np.float32)
# (image shape, max_per_tile, chunk): square, ragged, and a cap of 32
# entries a tile that drops the deeper ones.
CASES = [((64, 64), 2048, 128), ((96, 64), 2048, 128), ((64, 64), 32, 16)]


def scene(n=300, cams=2, seed=0):
    means, scales, quats, harm, op = np_scene(seed, n)
    covs = np.asarray(jbuild_cov(scales, quats))
    ext = np.tile(np.eye(4, dtype=np.float32), (cams, 1, 1))
    ext[:, 0, 3] = np.linspace(0.0, 0.1, cams, dtype=np.float32)
    ext[:, 1, 3] = np.linspace(0.0, -0.05, cams, dtype=np.float32)
    return {"extrinsics": ext, "intrinsics": np.tile(CAMERA_K, (cams, 1, 1)),
            "near": np.full((cams,), 0.8, np.float32),
            "far": np.full((cams,), 100.0, np.float32),
            "background": np.tile(BG, (cams, 1)), "means": means,
            "covariances": covs, "harmonics": harm, "opacities": op}


def jax_render(s, hw, cfg, **fields):
    s = {**s, **fields}
    return jrender(s["extrinsics"], s["intrinsics"], s["near"], s["far"], hw,
                   s["background"], s["means"], s["covariances"],
                   s["harmonics"], s["opacities"], cfg=cfg)


def torch_render(s, hw, cfg, **fields):
    s = {**{k: to_torch(v) for k, v in s.items()}, **fields}
    return render(s["extrinsics"], s["intrinsics"], s["near"], s["far"], hw,
                  s["background"], s["means"], s["covariances"],
                  s["harmonics"], s["opacities"], cfg=cfg)


def configs(max_per_tile, chunk):
    return (JRasterizerConfig(backend="tiled", max_per_tile=max_per_tile,
                              chunk=chunk),
            RasterizerConfig(backend="tiled", max_per_tile=max_per_tile,
                             chunk=chunk))


def weights(hw, cams=2, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cams, *hw, 3)).astype(np.float32),
            rng.standard_normal((cams, *hw)).astype(np.float32),
            rng.standard_normal((cams, *hw)).astype(np.float32)]


@pytest.mark.parametrize("hw,max_per_tile,chunk", CASES)
def test_tiled_render_matches_jax(hw, max_per_tile, chunk):
    s = scene()
    jcfg, tcfg = configs(max_per_tile, chunk)
    jout = jax_render(s, hw, jcfg)
    cuda_lib.reset_launch_counts()
    tout = torch_render(s, hw, tcfg)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())
    assert tout.color.shape == (2, *hw, 3)
    assert_images_close(tout.color.numpy(), np.asarray(jout.color))
    assert_images_close(tout.alpha.numpy(), np.asarray(jout.alpha))
    depth_max = float(np.abs(np.asarray(jout.depth)).max())
    assert_images_close(tout.depth.numpy() / depth_max,
                        np.asarray(jout.depth) / depth_max)
    np.testing.assert_array_equal(tout.dropped_entries.numpy(),
                                  np.asarray(jout.dropped_entries))
    assert tout.dropped_entries.dtype == torch.int32
    if max_per_tile < 2048:
        assert int(tout.dropped_entries.min()) > 0
    else:
        assert int(tout.dropped_entries.max()) == 0


@pytest.mark.parametrize("hw,max_per_tile,chunk", CASES)
def test_tiled_gradients_match_jax(hw, max_per_tile, chunk):
    """d(weighted color + depth + alpha) / d(means, opacities, pose)."""
    s = scene()
    jcfg, tcfg = configs(max_per_tile, chunk)
    w = weights(hw)

    def jloss(means, opacities, extrinsics):
        out = jax_render(s, hw, jcfg, means=means, opacities=opacities,
                         extrinsics=extrinsics)
        return sum(jnp.sum(o * wi) for o, wi in
                   zip((out.color, out.depth, out.alpha), w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        s["means"], s["opacities"], s["extrinsics"])
    leaves = [to_torch(s[k]).requires_grad_(True)
              for k in ("means", "opacities", "extrinsics")]
    out = torch_render(s, hw, tcfg, means=leaves[0], opacities=leaves[1],
                       extrinsics=leaves[2])
    loss = sum((o * to_torch(wi)).sum() for o, wi in
               zip((out.color, out.depth, out.alpha), w))
    tgrads = torch.autograd.grad(loss, leaves)
    for name, tg, jg in zip(("means", "opacities", "pose"), tgrads, jgrads):
        jg = np.asarray(jg)
        scale = np.abs(jg).max()
        assert scale > 0, name
        np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * scale,
                                   err_msg=name)


def test_bin_gaussians_matches_jax():
    """The sorted entry lists and tile starts equal JAX's (no depth ties
    among live Gaussians in this scene)."""
    means, scales, quats, harm, op = np_scene(3, 250)
    covs = np.asarray(jbuild_cov(scales, quats))
    eye = np.eye(4, dtype=np.float32)
    hw = (80, 48)
    jp = jproject(means, covs, harm, op, eye, CAMERA_K, hw)
    tp = project_gaussians(*map(to_torch, (means, covs, harm, op, eye,
                                           CAMERA_K)), hw)
    jb = jtiled.bin_gaussians(jp, hw, 8)
    tb = bin_gaussians(tp, hw, 8)
    assert tb.num_tiles_xy == jb.num_tiles_xy == (5, 3)
    np.testing.assert_array_equal(tb.tile_starts.numpy(),
                                  np.asarray(jb.tile_starts))
    n_live = int(tb.tile_starts[-1])
    assert n_live > 250
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.ids_sorted[:n_live].numpy(),
                                  np.asarray(jb.ids_sorted)[:n_live])


def test_rasterize_tiled_matches_jax():
    means, scales, quats, harm, op = np_scene(5, 200)
    covs = np.asarray(jbuild_cov(scales, quats))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -0.3
    args = (means, covs, harm, op, c2w, CAMERA_K, BG)
    jout = jtiled.rasterize_tiled(*args, image_shape=(48, 48), sh_degree=2,
                                  max_per_tile=256, chunk=64)
    tout = rasterize_tiled(*map(to_torch, args), (48, 48), sh_degree=2,
                           max_per_tile=256, chunk=64)
    for t, j in zip(tout, jout):
        assert_images_close(t.numpy(), np.asarray(j), atol=5e-5)


@pytest.mark.parametrize("backend", ["prefix", "tiled"])
def test_render_cameras_together_equal_alone(backend):
    """`render` rescales shared Gaussians one camera at a time: several
    cameras at different near planes give, bit for bit, what each camera
    gives alone."""
    s = {k: to_torch(v) for k, v in scene(cams=3, seed=4).items()}
    s["near"] = torch.tensor([0.5, 1.0, 2.0])
    cfg = RasterizerConfig(backend=backend)
    keys = ("extrinsics", "intrinsics", "near", "far", "background")

    def go(sel):
        return render(*[s[k][sel] for k in keys[:4]], (48, 48),
                      s["background"][sel], s["means"], s["covariances"],
                      s["harmonics"], s["opacities"], cfg=cfg)

    together = go(slice(None))
    for i in range(3):
        alone = go(slice(i, i + 1))
        for name in ("color", "depth", "alpha", "dropped_entries"):
            assert torch.equal(getattr(together, name)[i],
                               getattr(alone, name)[0]), (i, name)
