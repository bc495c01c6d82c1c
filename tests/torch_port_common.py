"""Shared helpers of the `test_torch_*` files (PyTorch port vs JAX).

Inputs are made with numpy from a seed and handed to both frameworks as
numpy arrays; JAX stays on the CPU (see conftest.py).
"""

import numpy as np
import pytest
import torch

# The suite runs several pytest-xdist workers at once: torch's default of
# one OpenMP thread per core in each of them oversubscribes the host, and
# the spinning threads slow the port's many small CPU ops tenfold or more.
torch.set_num_threads(min(2, torch.get_num_threads()))


def assert_images_close(actual, desired, atol=2e-5, frac=0.999, hard_atol=5e-3):
    """Allclose for rasterized images (copied from tests/test_rasterizer.py).

    Pixels sitting exactly on the T=1e-4 early-termination threshold can flip
    their break decision under different f32 reduction orders (chunked vs
    full cumprod) — identical behavior exists between CUDA runs. Require
    `frac` of pixels within `atol` and ALL pixels within `hard_atol`.
    """
    diff = np.abs(np.asarray(actual) - np.asarray(desired))
    assert diff.max() <= hard_atol, f"hard max diff {diff.max()}"
    ok = (diff <= atol).mean()
    assert ok >= frac, f"only {ok:.4%} of pixels within {atol}"


def np_scene(seed, n=200, d_sh=25, cov_scale=1.0):
    """Random Gaussians in front of an identity camera, as numpy arrays:
    means (n, 3), scales (n, 3), quats (n, 4), harmonics (n, 3, d_sh),
    opacities (n,)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [rng.uniform(-0.8, 0.8, (n, 2)), rng.uniform(1.5, 6.0, (n, 1))], -1
    )
    scales = (0.02 + 0.05 * rng.uniform(size=(n, 3))) * np.sqrt(cov_scale)
    quats = rng.standard_normal((n, 4))
    harmonics = 0.5 * rng.standard_normal((n, 3, d_sh))
    opacities = rng.uniform(0.3, 0.95, (n,))
    f32 = lambda x: np.asarray(x, np.float32)
    return tuple(map(f32, (means, scales, quats, harmonics, opacities)))


def conics(rng, n, log_sigma, log_ratio):
    """Inverses of rotated 2-D covariances with the given (log10) major
    sigma in pixels and (log10) axis ratio."""
    s1 = 10.0 ** rng.uniform(*log_sigma, n)
    s2 = s1 / 10.0 ** rng.uniform(*log_ratio, n)
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    cxx = cs**2 * s1**2 + sn**2 * s2**2
    cyy = sn**2 * s1**2 + cs**2 * s2**2
    cxy = cs * sn * (s1**2 - s2**2)
    det = cxx * cyy - cxy**2
    return cyy / det, -cxy / det, cxx / det


def near(rng, n, x):
    """x moved by a few float32 ulp."""
    x = np.asarray(x, np.float32)
    steps = rng.integers(-4, 5, n)
    return np.array([np.float32(v) for v in (
        x * (1 + steps * np.finfo(np.float32).eps))], np.float32)


def adversarial_entries(seed, n=4000, finite_only=False):
    """Seeded entries that stress the compositing kernels' cull, as float32
    columns (mx, my, a, b, c, op) with tile-local means: pixel-sized and
    wide Gaussians in and around the tile, near-singular, indefinite and
    negative conics, opacity within a few ulp of 1/255 and of 1, means
    just outside the tile, and (unless `finite_only`) non-finite fields."""
    rng = np.random.default_rng(seed)
    k = n // 8
    cases = []
    # Pixel-sized and wide Gaussians, means in and around the tile.
    for log_sigma, log_ratio in (((-0.5, 0.5), (0, 0.5)), ((0.5, 2.0), (0, 1)),
                                 ((0, 1), (1.5, 2.0))):
        a, b, c = conics(rng, k, log_sigma, log_ratio)
        cases.append((rng.uniform(-20, 36, k), rng.uniform(-20, 36, k), a, b,
                      c, rng.uniform(0.0, 1.0, k)))
    # Near-singular conics: axis ratios up to 1e4, both sides of the
    # conditioning limit.
    a, b, c = conics(rng, k, (0, 1.5), (2.0, 4.0))
    cases.append((rng.uniform(-8, 24, k), rng.uniform(-8, 24, k), a, b, c,
                  rng.uniform(0.05, 1.0, k)))
    # Indefinite, negative and degenerate conics.
    a = rng.uniform(-1, 1, k)
    c = rng.uniform(-1, 1, k)
    b = np.sqrt(np.abs(a * c)) * rng.uniform(0.9, 1.5, k)
    cases.append((rng.uniform(0, 16, k), rng.uniform(0, 16, k), a, b, c,
                  rng.uniform(0.05, 1.0, k)))
    # Opacity at a few ulp of 1/255 and of 1, means on and off pixels.
    a, b, c = conics(rng, k, (-0.3, 0.7), (0, 1))
    op = np.where(rng.uniform(size=k) < 0.5,
                  near(rng, k, np.float32(1) / np.float32(255)),
                  near(rng, k, np.minimum(1.0, rng.choice([0.99, 1.0], k))))
    m = np.where(rng.uniform(size=(2, k)) < 0.5,
                 rng.integers(-2, 18, (2, k)).astype(np.float64),
                 rng.uniform(-2, 18, (2, k)))
    cases.append((m[0], m[1], a, b, c, op))
    # Means just outside the tile: a box edge at a few ulp of the border.
    a, b, c = conics(rng, k, (-0.5, 0.5), (0, 0.5))
    ext = np.sqrt(2 * np.log(255 * 0.9) * c / (a * c - b * b))
    side = rng.choice([-1.0, 1.0], k)
    mx = np.where(side < 0, -ext, 15 + ext) * (1 + rng.uniform(-1e-3, 1e-3, k))
    cases.append((mx, rng.uniform(0, 16, k), a, b, c, np.full(k, 0.9)))
    # Non-finite fields.
    if not finite_only:
        a, b, c = conics(rng, k, (0, 1), (0, 1))
        bad = np.array([np.nan, np.inf, -np.inf])[rng.integers(0, 3, k)]
        field = rng.integers(0, 6, k)
        vals = [rng.uniform(0, 16, k), rng.uniform(0, 16, k), a, b, c,
                rng.uniform(0.05, 1.0, k)]
        for i in range(6):
            vals[i] = np.where(field == i, bad, vals[i])
        cases.append(tuple(vals))
    return [np.concatenate([case[i] for case in cases]).astype(np.float32)
            for i in range(6)]


CAMERA_K = np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32)


def to_torch(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda_device():
    """A CUDA device with nvcc, or skip: the hand-written kernels run only
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spfsplatv2_tpu_torch.ops import cuda_lib

    try:
        cuda_lib._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Tiny encoder: 2 encoder / 2 decoder blocks, narrow widths, float32
# compute.  Remat changes only what the backward keeps, so it is off on
# the JAX side; the port's default (on) is held against it and against
# remat off in test_torch_train.py.
TINY_BACKBONE = dict(
    patch_size=16, enc_depth=2, enc_embed_dim=64, enc_num_heads=4,
    dec_depth=2, dec_embed_dim=48, dec_num_heads=4, compute_dtype="float32",
)
TINY_HEADS = dict(sh_degree=1, dpt_feature_dim=32, dpt_last_dim=16,
                  dpt_layer_dims=(16, 24, 32, 48))


def jax_tiny_encoder():
    from spfsplatv2_tpu.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu.models.encoder import SPFSplatV2Config, SPFSplatV2Encoder

    return SPFSplatV2Encoder(SPFSplatV2Config(
        backbone=CrocoBackboneConfig(**TINY_BACKBONE, remat=False),
        remat_heads=False, **TINY_HEADS,
    ))


def torch_tiny_encoder(params):
    """The port's tiny encoder with weights moved from a flax tree."""
    from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu_torch.models.encoder import (
        SPFSplatV2Config,
        SPFSplatV2Encoder,
    )
    from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

    enc = SPFSplatV2Encoder(SPFSplatV2Config(
        backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS,
    ))
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    return enc.eval()


# Tiny VGGT encoder (the JAX package's tests/test_vggt.py sizes): a DINOv2
# of depth 1 and an aggregator of depth 2, width 32, 2 heads, float32
# compute; a camera head of width 64 and trunk depth 1; SH degree 1.
TINY_DINO = dict(patch_size=14, embed_dim=32, depth=1, num_heads=2,
                 num_register_tokens=2, native_grid=4, compute_dtype="float32")
TINY_AGG = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2,
                num_register_tokens=2, compute_dtype="float32")
TINY_CAMERA = dict(dim_in=64, trunk_depth=1, num_heads=2)


def jax_tiny_vggt(dtype="float32"):
    from spfsplatv2_tpu.models.encoder_vggt import (
        SPFSplatV2LConfig,
        SPFSplatV2LEncoder,
    )
    from spfsplatv2_tpu.models.vggt.aggregator import AggregatorConfig
    from spfsplatv2_tpu.models.vggt.camera_head import CameraHeadConfig
    from spfsplatv2_tpu.models.vggt.dinov2 import DinoV2Config

    dino = DinoV2Config(**{**TINY_DINO, "compute_dtype": dtype})
    return SPFSplatV2LEncoder(SPFSplatV2LConfig(
        aggregator=AggregatorConfig(**{**TINY_AGG, "compute_dtype": dtype},
                                    dinov2=dino),
        camera_head=CameraHeadConfig(**TINY_CAMERA), sh_degree=1))


def torch_tiny_vggt_config(dtype="float32", **camera):
    """The port's `SPFSplatV2LConfig` at the tiny sizes; `camera`
    overrides camera-head fields."""
    from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LConfig
    from spfsplatv2_tpu_torch.models.vggt.aggregator import AggregatorConfig
    from spfsplatv2_tpu_torch.models.vggt.camera_head import CameraHeadConfig
    from spfsplatv2_tpu_torch.models.vggt.dinov2 import DinoV2Config

    dino = DinoV2Config(**{**TINY_DINO, "compute_dtype": dtype})
    return SPFSplatV2LConfig(
        aggregator=AggregatorConfig(**{**TINY_AGG, "compute_dtype": dtype},
                                    dinov2=dino),
        camera_head=CameraHeadConfig(**{**TINY_CAMERA, **camera}),
        sh_degree=1)


def torch_tiny_vggt(params, dtype="float32"):
    """The port's tiny VGGT encoder with weights moved from a flax tree."""
    from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LEncoder
    from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

    enc = SPFSplatV2LEncoder(torch_tiny_vggt_config(dtype))
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    return enc.eval()


# Output layers that start small (the VGGT point head's output conv does
# not: its world points spread from pixel to pixel only through the
# kernel), and learned tokens drawn from N(0, 1).
OUTPUT_LAYERS = ("head_out", "fc_rot", "fc_t", "gaussian_param_head/output_conv2_2",
                 "pose_branch_fc2")
TOKENS = ("pose_token", "camera_token", "register_token", "cls_token",
          "register_tokens", "pos_embed", "empty_pose_tokens")


def random_flax_params(module, seed, *init_args, **static):
    """A seeded param tree of `module`'s structure, made with numpy.

    The structure comes from `jax.eval_shape(module.init, ...)` (seconds,
    where an eager init takes about a minute).  Kernels are LeCun-scaled
    normals; biases, LayerNorm affines, LayerScales and the learned
    tokens are random too, so every weight of the layout is exercised.
    The output layers keep their calibrated scale (points start near
    z = 2.3, small Gaussians) and the pose heads a near-identity rotation
    (the VGGT camera head's xyzw quaternion leans to w), so renders stay
    sane.  Keyword arguments reach `module.init` untraced (Python ints
    and tuples that index or size arrays).
    """
    import functools

    import jax

    shapes = jax.eval_shape(functools.partial(module.init, **static),
                            jax.random.PRNGKey(0), *init_args)
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        name, shape = names[-1], leaf.shape
        mod = names[-2] if len(names) > 1 else ""
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            small = mod in OUTPUT_LAYERS or "/".join(names[-3:-1]) in OUTPUT_LAYERS
            scale = 0.1 if small else 1.0
            x = rng.standard_normal(shape) * scale / np.sqrt(fan_in)
        elif name in ("scale", "gamma"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in TOKENS:
            x = rng.standard_normal(shape)
        else:  # biases
            x = 0.05 * rng.standard_normal(shape)
            # The points' z: the CroCo head's 3 channels (near 2.3), the
            # VGGT point head's 4 (xyz and confidence; its points spread
            # more, so they start further, near 6.4, clear of near = 1).
            if mod == "head_out" and shape == (3,):
                x[2] += 1.2
            if mod == "output_conv2_2" and shape == (4,):
                x[2] += 2.0
            if mod == "fc_rot":
                x = x + np.asarray([1.0, 0, 0, 0, 1.0, 0])
            if mod == "pose_branch_fc2":
                x[6] += 1.0
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


# ---- the command line: a tiny synthetic test split and its overrides ----

CLI_INDEX = {
    "scene_000": {"context": [0, 6], "target": [3, 4], "overlap": 0.2},
    "scene_001": {"context": [2, 8], "target": [5], "overlap": 0.5},
}


def cli_test_split(root):
    """Two 12-frame 32x32 synthetic scenes under `root/test` and their
    evaluation index `root/index.json`."""
    import json

    from spfsplatv2_tpu_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(root, 2, 12, (32, 32), "test")
    (root / "index.json").write_text(json.dumps(CLI_INDEX))
    return root


def _cli_data_overrides(root, out_dir, side):
    """`root`'s 32x32 synthetic data at `side` x `side`, outputs under
    `out_dir`, no pretrained weights."""
    return [f"dataset.roots=['{root}']", "dataset.original_image_shape=[32,32]",
            f"dataset.input_image_shape=[{side},{side}]",
            f"image_shape=[{side},{side}]",
            f"evaluation_sampler.index_path={root / 'index.json'}",
            f"test.output_path={out_dir}", f"output_dir={out_dir}",
            "checkpointing.pretrained_weights=null"]


def cli_overrides(root, out_dir, extra=()):
    """Overrides of experiments/spfsplatv2/re10k.yaml for the tiny encoder
    (float32 compute) at 32x32 on `root`'s synthetic data."""
    ov = _cli_data_overrides(root, out_dir, 32)
    for k, v in TINY_BACKBONE.items():
        ov.append(f"encoder.spfsplatv2.backbone.{k}={v}")
    for k, v in TINY_HEADS.items():
        ov.append(f"encoder.spfsplatv2.{k}={list(v) if isinstance(v, tuple) else v}")
    return ov + list(extra)


def vggt_encoder_overrides():
    """`encoder.name=spfsplatv2l` at the tiny VGGT sizes."""
    ov = ["encoder.name=spfsplatv2l", "encoder.spfsplatv2l.sh_degree=1"]
    for part, sizes in (("aggregator", TINY_AGG),
                        ("aggregator.dinov2", TINY_DINO),
                        ("camera_head", TINY_CAMERA)):
        ov += [f"encoder.spfsplatv2l.{part}.{k}={v}" for k, v in sizes.items()]
    return ov


def vggt_cli_overrides(root, out_dir, extra=()):
    """Overrides of experiments/spfsplatv2-l/re10k.yaml for the tiny VGGT
    encoder at 28x28 (2 x 2 patches) on `root`'s synthetic data."""
    return (_cli_data_overrides(root, out_dir, 28) + vggt_encoder_overrides()
            + list(extra))


def lpips_weights_file(path, seed=0):
    """A seeded LPIPS in the `lpips.LPIPS(net="vgg")` state_dict layout,
    saved with torch.save: both packages load it through
    `loss.lpips_weights_path`."""
    from spfsplatv2_tpu_torch.losses.lpips import _SLICE_CONVS, build_lpips

    ours = build_lpips(seed, device="cpu").state_dict()
    sd = {}
    for s, idxs in _SLICE_CONVS.items():
        for i, idx in enumerate(idxs):
            for leaf in ("weight", "bias"):
                sd[f"net.slice{s}.{idx}.{leaf}"] = ours[f"vgg.conv{s}_{i + 1}.{leaf}"]
    for s in range(5):
        sd[f"lin{s}.model.1.weight"] = ours[f"lin{s}"][None, :, None, None]
    torch.save(sd, path)
    return path


def per_camera(decode):
    """The JAX package's `decode_splatting`, one camera a call.  JAX's
    `render` unrolls its camera loop into one XLA program, about half a
    second of CPU compile a camera; a video's frames then compile once."""
    import types

    import jax.numpy as jnp

    def one_at_a_time(gaussians, extrinsics, intrinsics, near, far, shape,
                      cfg):
        colors = [decode(gaussians, extrinsics[:, i:i + 1],
                         intrinsics[:, i:i + 1], near[:, i:i + 1],
                         far[:, i:i + 1], shape, cfg).color
                  for i in range(extrinsics.shape[1])]
        return types.SimpleNamespace(color=jnp.concatenate(colors, axis=1))

    return one_at_a_time


def jitted(module):
    """A flax module whose `apply` is jitted, for JAX code that applies
    it op by op (tens of seconds of CPU compile a new shape)."""
    import types

    import jax

    return types.SimpleNamespace(apply=jax.jit(module.apply))


def cli_checkpoints(params, tmp_path):
    """The same flax params as a JAX orbax checkpoint and as the port's
    checkpoint; -> (jax dir, port dir)."""
    from spfsplatv2_tpu.training.loop import save_checkpoint

    from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

    save_checkpoint(tmp_path / "jax_ckpt", {"params": params}, 0)
    port = tmp_path / "port_ckpt" / "step_0"
    port.mkdir(parents=True)
    torch.save({"encoder": flax_to_state_dict(params)}, port / "state.pt")
    return tmp_path / "jax_ckpt" / "step_0", port


# ---- reference checkpoints and the tiny DUSt3R teacher -------------------

# The tiny sizes of TINY_BACKBONE, as the teacher's masked backbone.
TINY_TEACHER_BACKBONE = dict(TINY_BACKBONE, intrinsics_token=False,
                             pose_token=False)


def tiny_teacher_config():
    from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu_torch.models.distiller import DistillerConfig

    return DistillerConfig(backbone=CrocoBackboneConfig(**TINY_TEACHER_BACKBONE))


def tiny_teacher_loader(monkeypatch):
    """Route `training/loop.py:load_distiller_params` to the tiny teacher
    (its default is the full-width DUSt3R)."""
    from spfsplatv2_tpu_torch.training import loop

    real = loop.load_distiller_params
    monkeypatch.setattr(loop, "load_distiller_params",
                        lambda path, seed, device: real(
                            path, seed, device, tiny_teacher_config()))
