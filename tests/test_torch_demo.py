"""The port's demo and its modules vs the JAX package on the CPU:
`matrix_to_quaternion`, `geometry/projection.py`, the camera
trajectories, the PLY export and `run_demo` itself.

JAX's `decode_splatting` unrolls its camera loop into one XLA program,
about half a second of CPU compile a camera, so the JAX demo's 60-frame
video is rendered here through the same function one camera a call
(`per_camera`): the same render, compiled once; its encoder's `apply`
is jitted (`jitted`) where the demo would apply it op by op.  The demos
run at 32^2:
on the CPU the port composites through K1's plain version, 0.7 s a
frame at 64^2 (43 s for the 60 frames), 0.07 s at 32^2.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spfsplatv2_tpu import demo as jdemo
from spfsplatv2_tpu.evaluation import video as jvideo
from spfsplatv2_tpu.geometry import projection as jproj
from spfsplatv2_tpu.geometry import se3 as jse3
from spfsplatv2_tpu.models import encoder as jencoder
from spfsplatv2_tpu.models.croco.backbone import CrocoBackboneConfig as JBackbone
from spfsplatv2_tpu.utils import camera_trajectory as jtraj
from spfsplatv2_tpu.utils import ply_export as jply
from spfsplatv2_tpu_torch import demo
from spfsplatv2_tpu_torch.geometry import projection
from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.utils import camera_trajectory as traj
from spfsplatv2_tpu_torch.utils import ply_export

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    TINY_BACKBONE,
    TINY_HEADS,
    cli_checkpoints,
    jax_tiny_encoder,
    jitted,
    per_camera,
    random_flax_params,
)


def rotations(case, n=64, seed=0):
    """Random rotations, or rotations 1e-3 to 1e-2 rad short of 180
    degrees about axes near x, y or z (each of Shepperd's branches)."""
    rng = np.random.default_rng(seed)
    if case == "random":
        q = rng.standard_normal((n, 4))
    else:
        axis = np.eye(3)["xyz".index(case)] + 0.05 * rng.standard_normal((n, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        half = (np.pi - rng.uniform(1e-3, 1e-2, n)) / 2
        q = np.concatenate([np.cos(half)[:, None],
                            np.sin(half)[:, None] * axis], -1)
    return np.asarray(jse3.quaternion_to_matrix(q.astype(np.float32)))


@pytest.mark.parametrize("case", ["random", "x", "y", "z"])
def test_matrix_to_quaternion_matches_jax(case):
    m = rotations(case)
    ours = se3.matrix_to_quaternion(torch.from_numpy(m)).numpy()
    ref = np.asarray(jse3.matrix_to_quaternion(m))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    assert np.all(ours[:, 0] >= 0)
    if case != "random":
        # The branch taken: the axis's component dominates.
        k = 1 + "xyz".index(case)
        assert np.all(np.abs(ours[:, k]) > 0.9)


def _projection_inputs(seed=1):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    k = np.tile(CAMERA_K, (5, 1, 1))
    k[:, 0, 0] = rng.uniform(0.7, 1.3, 5)
    k[:, 1, 1] = rng.uniform(0.7, 1.3, 5)
    k[:, :2, 2] = rng.uniform(0.4, 0.6, (5, 2))
    c2w = np.asarray(jse3.se3_exp(f32(rng.normal(0, 0.3, (5, 6)))))
    return {"points": f32(rng.uniform(-1, 1, (5, 7, 3)) + [0, 0, 2.5]),
            "coords": f32(rng.uniform(0, 1, (5, 7, 2))),
            "z": f32(rng.uniform(0.5, 4, (5, 7))),
            "k": f32(k), "c2w": c2w,
            "dirs": f32(rng.standard_normal((5, 3))),
            "orig": f32(rng.standard_normal((5, 3))),
            "dirs_b": f32(rng.standard_normal((5, 3))),
            "orig_b": f32(rng.standard_normal((5, 3)) + 1.0)}


PROJECTION_CALLS = {
    "homogenize_points": lambda m, x: m.homogenize_points(x["points"]),
    "homogenize_vectors": lambda m, x: m.homogenize_vectors(x["points"]),
    "transform_rigid": lambda m, x: m.transform_rigid(
        m.homogenize_points(x["points"]), x["c2w"][:, None]),
    "transform_cam2world": lambda m, x: m.transform_cam2world(
        m.homogenize_points(x["points"]), x["c2w"][:, None]),
    "transform_world2cam": lambda m, x: m.transform_world2cam(
        m.homogenize_points(x["points"]), x["c2w"][:, None]),
    "project": lambda m, x: m.project(x["points"], x["k"][:, None]),
    "unproject": lambda m, x: m.unproject(x["coords"], x["z"],
                                          x["k"][:, None]),
    "get_world_rays": lambda m, x: m.get_world_rays(
        x["coords"], x["c2w"][:, None], x["k"][:, None]),
    "sample_image_grid": lambda m, x: m.sample_image_grid((5, 7)),
    "get_fov": lambda m, x: m.get_fov(x["k"]),
    "unnormalize_intrinsics": lambda m, x: m.unnormalize_intrinsics(
        x["k"], (48, 80)),
    "normalize_intrinsics": lambda m, x: m.normalize_intrinsics(
        m.unnormalize_intrinsics(x["k"], (48, 80)), (48, 80)),
    "intersect_rays": lambda m, x: m.intersect_rays(
        x["orig"], x["dirs"], x["orig_b"], x["dirs_b"]),
}


@pytest.mark.parametrize("name", sorted(PROJECTION_CALLS))
def test_projection_matches_jax(name):
    x = _projection_inputs()
    call = PROJECTION_CALLS[name]
    ours = call(projection, {k: torch.from_numpy(v) for k, v in x.items()})
    ref = call(jproj, {k: jnp.asarray(v) for k, v in x.items()})
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(o.numpy(), r)
        else:
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-6, atol=1e-7)


def test_trajectories_match_jax():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 1, 9, dtype=np.float32)
    a, b = (np.asarray(jse3.se3_exp(rng.normal(0, 0.4, 6).astype(np.float32)))
            for _ in range(2))
    k0, k1 = CAMERA_K, CAMERA_K * np.float32(1.2)
    radius = np.float32([0.1, 0.3])
    pairs = [
        (traj.generate_wobble_transformation(radius, t),
         jtraj.generate_wobble_transformation(radius, t)),
        (traj.generate_wobble_transformation(0.5, t, 5, False),
         jtraj.generate_wobble_transformation(0.5, t, 5, False)),
        (traj.generate_wobble(a, 0.2, t), jtraj.generate_wobble(a, 0.2, t)),
        (traj.generate_spin(12, 30.0, 2.0), jtraj.generate_spin(12, 30.0, 2.0)),
        (traj.interpolate_intrinsics(k0, k1, t),
         jtraj.interpolate_intrinsics(k0, k1, t)),
        (traj.interpolate_extrinsics(a, b, t),
         jtraj.interpolate_extrinsics(a, b, t)),
        # The exaggerated video extrapolates: t * 5 - 2 runs over [-2, 3].
        (traj.interpolate_extrinsics(a, b, t * 5 - 2),
         jtraj.interpolate_extrinsics(a, b, t * 5 - 2)),
        (traj.interpolate_intrinsics(k0, k1, t * 5 - 2),
         jtraj.interpolate_intrinsics(k0, k1, t * 5 - 2)),
    ]
    for i, (ours, ref) in enumerate(pairs):
        assert ours.shape == ref.shape and ours.dtype == np.float32, i
        np.testing.assert_allclose(ours, ref, atol=1e-5, err_msg=str(i))
    ends = traj.interpolate_extrinsics(a, b, np.float32([0, 1]))
    np.testing.assert_allclose(ends, np.stack([a, b]), atol=1e-5)


def np_gaussians(seed=3, g=500, d_sh=9):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    quats = rng.standard_normal((g, 4))
    return (f32(rng.normal(0, 1, (g, 3)) + [0.3, -0.2, 2.0]),
            f32(rng.uniform(0.01, 0.2, (g, 3))),
            f32(quats / np.linalg.norm(quats, axis=-1, keepdims=True)),
            f32(rng.standard_normal((g, 3, d_sh))),
            f32(rng.uniform(0, 1, g)))


def assert_ply_close(ours_path, ref_path, rel, rot_atol):
    ours, ref = ply_export.load_ply(ours_path), jply.load_ply(ref_path)
    for key in ("means", "harmonics_dc", "opacities", "scales"):
        np.testing.assert_allclose(ours[key], ref[key],
                                   atol=rel * np.abs(ref[key]).max(),
                                   err_msg=key)
    # q and -q are one rotation: align signs before comparing.
    sign = np.sign(np.sum(ours["rotations"] * ref["rotations"], -1))
    np.testing.assert_allclose(ours["rotations"] * sign[:, None],
                               ref["rotations"], atol=rot_atol)


def _header(path):
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    return data[:end], len(data) - end


def test_export_ply_matches_jax(tmp_path):
    g = np_gaussians()
    ply_export.export_ply(*g, tmp_path / "ours.ply")
    jply.export_ply(*g, tmp_path / "ref.ply")
    (h_ours, n_ours), (h_ref, n_ref) = (_header(tmp_path / "ours.ply"),
                                        _header(tmp_path / "ref.ply"))
    assert h_ours == h_ref and n_ours == n_ref == 500 * 17 * 4
    assert_ply_close(tmp_path / "ours.ply", tmp_path / "ref.ply", 1e-6, 1e-5)
    # Tensors in, the same file out.
    ply_export.export_ply(*map(torch.from_numpy, g), tmp_path / "t.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "ours.ply").read_bytes()


# ---- run_demo -------------------------------------------------------------

SIZE = 32


def jax_tiny_config(real=jencoder.SPFSplatV2Config):
    return lambda: real(backbone=JBackbone(**TINY_BACKBONE, remat=False),
                        remat_heads=False, **TINY_HEADS)


def torch_tiny_config(real=demo.SPFSplatV2Config):
    return lambda: real(backbone=CrocoBackboneConfig(**TINY_BACKBONE),
                        **TINY_HEADS)


def photos(tmp_path):
    """Two seeded non-square photos (the crop and the resize both run)."""
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate([(80, 96), (112, 84)]):
        yy, xx = np.mgrid[:h, :w]
        base = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 7.0)], -1)
        img = np.clip(base + 0.1 * rng.standard_normal((h, w, 3)), 0, 1)
        paths.append(str(tmp_path / f"photo{i}.png"))
        Image.fromarray((img * 255).astype(np.uint8)).save(paths[-1])
    return paths


def gif_frames(path):
    with Image.open(path) as im:
        return im.n_frames, im.size


def test_run_demo_matches_jax(tmp_path, monkeypatch):
    img = np.zeros((1, 2, SIZE, SIZE, 3), np.float32)
    k = np.tile(CAMERA_K, (1, 2, 1, 1))
    params = random_flax_params(jax_tiny_encoder(), 3, img, k)
    jckpt, tckpt = cli_checkpoints(params, tmp_path)
    monkeypatch.setattr(jencoder, "SPFSplatV2Config", jax_tiny_config())
    monkeypatch.setattr(jencoder, "SPFSplatV2Encoder",
                        lambda cfg, real=jencoder.SPFSplatV2Encoder:
                        jitted(real(cfg)))
    monkeypatch.setattr(demo, "SPFSplatV2Config", torch_tiny_config())
    monkeypatch.setattr(jvideo, "decode_splatting",
                        per_camera(jvideo.decode_splatting))
    paths = photos(tmp_path)

    ref = jdemo.run_demo(paths, str(jckpt), str(tmp_path / "jax"), SIZE)
    cuda_lib.reset_launch_counts()
    ours = demo.run_demo(paths, str(tckpt), str(tmp_path / "torch"), SIZE,
                         device="cpu")
    assert not any(cuda_lib.launches().values())
    assert ours["poses"].shape == (2, 4, 4)
    np.testing.assert_allclose(ours["poses"], ref["poses"], atol=1e-4)
    # A real relative pose, not the identity.
    assert np.abs(ours["poses"][1] - np.eye(4)).max() > 1e-3
    assert _header(tmp_path / "torch/gaussians.ply") == _header(
        tmp_path / "jax/gaussians.ply")
    assert_ply_close(tmp_path / "torch/gaussians.ply",
                     tmp_path / "jax/gaussians.ply", 1e-4, 1e-4)
    frames = gif_frames(tmp_path / "torch/interpolation.gif")
    assert frames == gif_frames(tmp_path / "jax/interpolation.gif")
    assert frames == (60 + 58, (SIZE, SIZE))


def test_run_demo_without_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(demo, "SPFSplatV2Config", torch_tiny_config())
    demo.main([*photos(tmp_path), "--image-size", str(SIZE), "--output",
               str(tmp_path / "out"), "--device", "cpu"])
    assert "no checkpoint given" in capsys.readouterr().out
    ply = ply_export.load_ply(tmp_path / "out/gaussians.ply")
    assert ply["means"].shape == (2 * SIZE * SIZE, 3)
    assert np.isfinite(ply["means"]).all()
    n, size = gif_frames(tmp_path / "out/interpolation.gif")
    assert size == (SIZE, SIZE) and n >= 1


@pytest.mark.parametrize("size,key", [(64, "rank"), (256, "rank"),
                                      (1024, "quantized")])
def test_demo_depth_key_rule(size, key):
    """Two views of size^2 Gaussians over (size / 16)^2 tiles: the exact
    depth rank while rank and tile id fit the 31-bit key (where JAX's
    binning runs), the quantized key past it (where JAX's raises:
    21 + 13 bits at 1024^2)."""
    g = 2 * size * size
    row_bits = max((g - 1).bit_length(), 1)
    tile_bits = ((size // 16) ** 2 + 1).bit_length()
    assert (row_bits + tile_bits > 31) == (key == "quantized")
    cfg = demo.demo_decoder_config(g, (size, size))
    assert cfg.rasterizer.depth_key == key
    if key == "rank":
        assert cfg == DecoderConfig()
