"""The port's `decode_orthographic` vs the JAX package's on the CPU.

The same numpy scene and cameras go through both: "tiled" against
"tiled", and the port's "prefix" (plain K1/K2/K3) against JAX's "pallas"
(Pallas kernels in interpret mode); gradients of a photometric loss with
respect to the means and the c2w pose against JAX's Pallas path and its
dense oracle; the projection at the orthographic path's magnitudes; JAX's
two orthographic properties on the port; and the quantized depth key,
which orders the moved-back scene by index in JAX's binning and by
depth in the port's.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.gaussians import Gaussians as JGaussians
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.models.decoder import decode_orthographic as jdecode_ortho
from spfsplatv2_tpu.ops import raster_tiled as jtiled
from spfsplatv2_tpu.ops.covariance import build_covariance as jbuild_cov
from spfsplatv2_tpu.ops.raster_common import ProjectedGaussians as JProjected
from spfsplatv2_tpu.ops.raster_common import project_gaussians as jproject
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu_torch.gaussians import Gaussians
from spfsplatv2_tpu_torch.models.decoder import (
    DecoderConfig,
    decode_orthographic,
    decode_splatting,
    orthographic_cameras,
)
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.covariance import build_covariance
from spfsplatv2_tpu_torch.ops.raster_common import (
    ProjectedGaussians,
    project_gaussians,
)
from spfsplatv2_tpu_torch.ops.raster_cuda import composite_prefix
from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    assert_images_close,
    np_scene,
    to_torch,
)

HW = (64, 64)


def scene(n=200, seed=0, opacity=None):
    """One scene (b = 1) of `n` Gaussians and two cameras: the identity
    and one turned 8 degrees about y and moved aside, with world-space
    view widths and heights (non-square in the first view)."""
    means, scales, quats, harm, op = np_scene(seed, n, d_sh=4)
    if opacity is not None:
        op = (opacity[0] + (opacity[1] - opacity[0]) * (op - 0.3) / 0.65
              ).astype(np.float32)
    covs = np.asarray(jbuild_cov(scales, quats))
    th = np.deg2rad(8.0)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    ext[0, 1, :3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                         [-np.sin(th), 0, np.cos(th)]]
    ext[0, 1, :3, 3] = [-0.3, 0.05, 0.2]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return {
        "gaussians": {"means": means[None], "covariances": covs[None],
                      "scales": scales[None], "rotations": quats[None],
                      "harmonics": harm[None], "opacities": op[None]},
        "extrinsics": ext,
        "width": f32([[2.0, 2.4]]), "height": f32([[1.6, 2.4]]),
        "near": f32([[0.5, 0.8]]), "far": f32([[100.0, 100.0]]),
    }


def jax_decode(s, jcfg, **gaussians):
    g = JGaussians(**{**{k: jnp.asarray(v) for k, v in
                         s["gaussians"].items()}, **gaussians})
    return jdecode_ortho(g, jnp.asarray(s["extrinsics"]), s["width"],
                         s["height"], s["near"], s["far"], HW, jcfg)


def torch_decode(s, cfg, extrinsics=None, **gaussians):
    g = Gaussians(**{**{k: to_torch(v) for k, v in s["gaussians"].items()},
                     **gaussians})
    ext = to_torch(s["extrinsics"]) if extrinsics is None else extrinsics
    return decode_orthographic(g, ext, *(to_torch(s[k]) for k in (
        "width", "height", "near", "far")), HW, cfg)


def configs(backend, jbackend, scale_invariant=True):
    return (JDecoderConfig(make_scale_invariant=scale_invariant,
                           rasterizer=JRasterizerConfig(
                               backend=jbackend, entry_budget_factor=4.0,
                               chunk=64)),
            DecoderConfig(make_scale_invariant=scale_invariant,
                          rasterizer=RasterizerConfig(
                              backend=backend, entry_budget_factor=4.0,
                              chunk=64)))


@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("backend,jbackend", [("tiled", "tiled"),
                                              ("prefix", "pallas")])
def test_decode_orthographic_matches_jax(backend, jbackend, scale_invariant):
    s = scene()
    jcfg, tcfg = configs(backend, jbackend, scale_invariant)
    jout = jax_decode(s, jcfg)
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        tout = torch_decode(s, tcfg)
    assert all(v == 0 for v in cuda_lib.launch_counts.values())
    assert tout.color.shape == (1, 2, *HW, 3)
    assert float(tout.alpha.max()) > 0.5
    assert_images_close(tout.color.numpy(), np.asarray(jout.color), atol=3e-5)
    assert_images_close(tout.alpha.numpy(), np.asarray(jout.alpha), atol=3e-5)
    depth_max = float(np.abs(np.asarray(jout.depth)).max())
    assert_images_close(tout.depth.numpy() / depth_max,
                        np.asarray(jout.depth) / depth_max, atol=3e-5)
    np.testing.assert_array_equal(tout.dropped_entries.numpy(),
                                  np.asarray(jout.dropped_entries))


# The bars of tests/test_torch_train.py: JAX's Pallas gradients sit ~1e-3
# of max from its own dense oracle (ROADMAP.md section 3), the port's
# within 1e-4 of it.  Opacities below 0.35 keep every alpha above 1/255
# inside the binning's 3-sigma boxes, which the oracle does not have.
@pytest.mark.parametrize("jbackend,tol",
                         [("pallas", 2e-3), ("reference", 1e-4)])
def test_decode_orthographic_gradients_match_jax(jbackend, tol):
    s = scene(opacity=(0.05, 0.34))
    jcfg, tcfg = configs("prefix", jbackend)
    target = np.random.default_rng(5).uniform(0, 1, (1, 2, *HW, 3)).astype(
        np.float32)

    def jloss(means, extrinsics):
        out = jdecode_ortho(
            JGaussians(**{**{k: jnp.asarray(v) for k, v in
                             s["gaussians"].items()}, "means": means}),
            extrinsics, s["width"], s["height"], s["near"], s["far"], HW,
            jcfg)
        return jnp.sum((out.color - target) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(s["gaussians"]["means"]), jnp.asarray(s["extrinsics"]))
    means = to_torch(s["gaussians"]["means"]).requires_grad_(True)
    ext = to_torch(s["extrinsics"]).requires_grad_(True)
    out = torch_decode(s, tcfg, extrinsics=ext, means=means)
    loss = ((out.color - to_torch(target)) ** 2).sum()
    tgrads = torch.autograd.grad(loss, [means, ext])
    for name, tg, jg in zip(("means", "c2w"), tgrads, jgrads):
        jg = np.asarray(jg)
        scale = np.abs(jg).max()
        assert scale > 0 and torch.isfinite(tg).all(), name
        np.testing.assert_allclose(tg.numpy(), jg, atol=tol * scale,
                                   err_msg=name)


def test_projection_at_orthographic_magnitudes_matches_jax():
    """The moved-back camera shrinks every 3-D covariance by (near +
    distance)^2 under the scale-invariant rescale: the conics, the radii
    and the 3-sigma boxes still agree with JAX's."""
    s = scene()
    g = s["gaussians"]
    ext, k, near, _ = (x.numpy() for x in orthographic_cameras(
        *(to_torch(s[key]) for key in ("extrinsics", "width", "height",
                                       "near", "far"))))
    for v in range(2):
        scale = np.float32(1.0) / near[0, v]
        c2w = ext[0, v].copy()
        c2w[:3, 3] *= scale
        args = (g["means"][0] * scale, g["covariances"][0] * scale ** 2,
                g["harmonics"][0], g["opacities"][0], c2w, k[0, v])
        assert np.abs(args[1]).max() < 1e-5
        jp = jproject(*args, HW)
        tp = project_gaussians(*map(to_torch, args), HW)
        for name in ("radius", "rx", "ry"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)),
                                          err_msg=name)
        assert int((tp.radius > 0).sum()) > 150
        for name in ("xy", "conic", "depth", "color"):
            j = np.asarray(getattr(jp, name))
            np.testing.assert_allclose(getattr(tp, name).numpy(), j,
                                       rtol=2e-5, atol=1e-6 * np.abs(j).max(),
                                       err_msg=name)


def _single(offsets_xy, depths):
    """The JAX test's scene: round Gaussians of scale 0.05 at the given
    (x, y) offsets and depths, as the port's `Gaussians` (b = 1)."""
    g = len(depths)
    means = torch.tensor([[x, y, z] for (x, y), z in zip(offsets_xy, depths)])
    scales = torch.full((g, 3), 0.05)
    quats = torch.cat([torch.ones(g, 1), torch.zeros(g, 3)], -1)
    return Gaussians(means=means[None],
                     covariances=build_covariance(scales, quats)[None],
                     scales=scales[None], rotations=quats[None],
                     harmonics=torch.full((1, g, 3, 1), 2.0),
                     opacities=torch.full((1, g), 0.95))


def _render(gaussians, width, backend):
    cfg = DecoderConfig(make_scale_invariant=False, rasterizer=RasterizerConfig(
        backend=backend, max_per_tile=128, chunk=128,
        max_tiles_per_gaussian=16))
    wh = torch.full((1, 1), width)
    with torch.no_grad():
        out = decode_orthographic(
            gaussians, torch.eye(4)[None, None], wh, wh,
            torch.full((1, 1), 0.1), torch.full((1, 1), 10.0), HW, cfg)
    img = out.color[0, 0].sum(-1).numpy()
    return np.nonzero(img > img.max() * 0.5)


@pytest.mark.parametrize("backend", ["tiled", "prefix"])
def test_depth_invariant_projection(backend):
    """Parallel rays: the same (x, y) at different z lands on the same
    pixel (tests/test_orthographic.py, on the port)."""
    c1, c2 = (tuple(a.mean() for a in _render(_single([(0.5, -0.3)], [z]),
                                               2.0, backend))
              for z in (1.0, 5.0))
    assert abs(c1[0] - c2[0]) < 1.5 and abs(c1[1] - c2[1]) < 1.5, (c1, c2)


@pytest.mark.parametrize("backend", ["tiled", "prefix"])
def test_world_width_sets_scale(backend):
    """Doubling the world-space view width halves the on-screen offset."""
    off2, off4 = (_render(_single([(0.5, 0.0)], [2.0]), wd, backend)[1].mean()
                  - (HW[1] - 1) / 2 for wd in (2.0, 4.0))
    assert 1.6 < off2 / off4 < 2.4, (off2, off4)


# ---- the quantized depth key on the orthographic path ---------------------

KEY_SHAPE = (1024, 1024)   # 4096 tiles: 13 key bits of tile id, 18 of depth


def _pair(depths):
    """Two overlapping round Gaussians at the centre of a 1024^2 image."""
    g = len(depths)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return JProjected(
        xy=f32([[512.0, 512.0]] * g), conic=f32([[0.1, 0.0, 0.1]] * g),
        depth=f32(depths), color=f32([[1.0, 0.0, 0.0]] * g),
        opacity=f32([0.9] * g), radius=np.full(g, 10, np.int32),
        rx=np.full(g, 10, np.int32), ry=np.full(g, 10, np.int32))


def _tile_order(bins):
    """Each occupied tile's source rows, front to back."""
    return [bins.src[s:s + c].tolist() for s, c in
            zip(bins.starts.tolist(), bins.counts.tolist()) if c]


def test_jax_quantized_key_orders_a_moved_back_pair_by_index():
    """JAX's fault: at ~1146 world units from the camera (0.5 x width 2 /
    tan(0.05 deg)), depths 1146.4 and 1146.0 share the quantized key's 18
    bits at a 1024^2 image, so the farther Gaussian, listed first,
    composites in front.  The port keys the same bits under "quantized"
    and keys the distance behind the nearest under "relative", which
    `decode_orthographic` takes."""
    bits = np.asarray([1146.4, 1146.0], np.float32).view(np.int32) >> 13
    assert bits[0] == bits[1]
    jp = _pair([1146.4, 1146.0])
    args = (KEY_SHAPE, 16, 64, 32)
    for key, want in (("quantized", [0, 1]), ("rank", [1, 0])):
        jb = jtiled.bin_gaussians_prefix(jp, *args, depth_key=key,
                                         interpret=True)
        jorder = [np.asarray(jb.src)[s:s + c].tolist() for s, c in
                  zip(np.asarray(jb.starts), np.asarray(jb.counts)) if c]
        assert jorder and all(o == want for o in jorder), (key, jorder)
        tb = bin_gaussians_prefix(ProjectedGaussians(*map(to_torch, jp)),
                                  *args, depth_key=key)
        assert _tile_order(tb) == jorder, key
    tb = bin_gaussians_prefix(ProjectedGaussians(*map(to_torch, jp)), *args,
                              depth_key="relative")
    assert all(o == [1, 0] for o in _tile_order(tb))


def test_relative_key_composites_in_depth_order_at_1024_key_bits():
    """The orthographic scene at 64^2 binned with a 1024^2 image's key
    bits: the quantized key's render departs from the exact depth order's
    (the rank key's) in most pixels, the relative key's agrees with it
    within 1e-4 in 99.9% of them."""
    s = scene(n=400, opacity=(0.5, 0.95))
    g = s["gaussians"]
    ext, k, near, _ = orthographic_cameras(
        *(to_torch(s[key]) for key in ("extrinsics", "width", "height",
                                       "near", "far")))
    scale = 1.0 / near[0, 0]
    c2w = ext[0, 0].clone()
    c2w[:3, 3] *= scale
    proj = project_gaussians(to_torch(g["means"][0]) * scale,
                             to_torch(g["covariances"][0]) * scale ** 2,
                             to_torch(g["harmonics"][0]),
                             to_torch(g["opacities"][0]), c2w, k[0, 0], HW)
    bg = torch.zeros(3)
    color = {}
    for key in ("rank", "quantized", "relative"):
        bins = bin_gaussians_prefix(proj, HW, 16, 64, 4 * 400, 4,
                                    depth_key=key, key_shape=KEY_SHAPE)
        color[key] = composite_prefix(proj, bins, HW, bg)[0]
    off = (color["quantized"] - color["rank"]).abs().amax(-1)
    assert float((off <= 1e-4).float().mean()) < 0.5
    assert_images_close(color["relative"], color["rank"], atol=1e-4)


def test_decode_orthographic_takes_the_relative_key():
    """Under `depth_key="quantized"`, `decode_orthographic` renders as
    `decode_splatting` on its cameras under "relative", and in depth
    order, as the rank key does."""
    s = scene(n=300, opacity=(0.5, 0.95))
    gs = Gaussians(**{k: to_torch(v) for k, v in s["gaussians"].items()})
    args = [to_torch(s[k]) for k in ("extrinsics", "width", "height", "near",
                                     "far")]
    out = {}
    for key in ("rank", "quantized"):
        cfg = DecoderConfig(rasterizer=RasterizerConfig(
            entry_budget_factor=4.0, chunk=64, depth_key=key))
        with torch.no_grad():
            out[key] = decode_orthographic(gs, *args, HW, cfg).color
            if key == "quantized":
                cams = orthographic_cameras(*args)
                bins_cfg = DecoderConfig(rasterizer=RasterizerConfig(
                    entry_budget_factor=4.0, chunk=64, depth_key="relative"))
                out["relative"] = decode_splatting(gs, *cams, HW,
                                                   bins_cfg).color
    assert_images_close(out["quantized"], out["rank"], atol=1e-4)
    np.testing.assert_array_equal(out["quantized"].numpy(),
                                  out["relative"].numpy())
