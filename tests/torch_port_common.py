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


def random_flax_params(module, seed, *init_args):
    """A seeded param tree of `module`'s structure, made with numpy.

    The structure comes from `jax.eval_shape(module.init, ...)` (seconds,
    where an eager init takes about a minute).  Kernels are LeCun-scaled
    normals; biases, LayerNorm affines and the pose token are random too,
    so every weight of the layout is exercised.  The output layers keep
    their calibrated scale (points start near z = 2.3, small Gaussians)
    and the pose heads a near-identity rotation, so renders stay sane.
    """
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        name, shape = names[-1], leaf.shape
        mod = names[-2] if len(names) > 1 else ""
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            scale = 0.1 if mod in ("head_out", "fc_rot", "fc_t") else 1.0
            x = rng.standard_normal(shape) * scale / np.sqrt(fan_in)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "pose_token":
            x = rng.standard_normal(shape)
        else:  # biases
            x = 0.05 * rng.standard_normal(shape)
            if mod == "head_out" and shape == (3,):
                x = x + np.asarray([0.0, 0.0, 1.2])
            if mod == "fc_rot":
                x = x + np.asarray([1.0, 0, 0, 0, 1.0, 0])
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)
