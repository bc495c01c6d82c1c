"""PyTorch port's encoder and its parts vs the JAX package on the CPU.

The same numpy params go through `SPFSplatV2Encoder.apply` and, moved by
`utils/from_flax.py`, through the port's encoder (float32 compute, 2
encoder / 2 decoder blocks, narrow widths, 32x32).  The parts below it
(geometry, SH, adapter, RoPE, attention, resize, a bf16 encoder block and
a float32 decoder block) are held one by one.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.geometry import se3 as jse3
from spfsplatv2_tpu.models import adapter as jadapter
from spfsplatv2_tpu.models.croco import layers as jlayers
from spfsplatv2_tpu.ops import attention as jattn
from spfsplatv2_tpu.ops.rope import rope_2d as jrope
from spfsplatv2_tpu.ops.sh import eval_sh_colors as jeval_sh
from spfsplatv2_tpu.utils.interp import resize_bilinear as jresize
from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models import adapter
from spfsplatv2_tpu_torch.models.croco import layers
from spfsplatv2_tpu_torch.ops import attention
from spfsplatv2_tpu_torch.ops.rope import rope_2d
from spfsplatv2_tpu_torch.ops.sh import eval_sh_colors
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict
from spfsplatv2_tpu_torch.utils.interp import resize_bilinear

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    jax_tiny_encoder,
    random_flax_params,
    to_torch,
    torch_tiny_encoder,
)

RTOL, ATOL = 1e-4, 1e-5


def close(actual, desired, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32)
    k = np.broadcast_to(np.asarray([[1.0, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]],
                                   np.float32), (1, 3, 3, 3)).copy()
    jenc = jax_tiny_encoder()
    args = (img[:, :2], k[:, :2], img[:, 2:], k[:, 2:])
    params = random_flax_params(jenc, 1, *args)
    return jenc, params, torch_tiny_encoder(params), args


@pytest.mark.parametrize("case", ["with_target", "context_only",
                                  "view_dropout"])
def test_encoder_matches_jax(encoders, case):
    jenc, params, tenc, args = encoders
    kwargs = {}
    if case == "context_only":
        args = args[:2]
    elif case == "view_dropout":
        # 3 context views, the last dropped from every memory set and
        # rendered with zero opacity.
        img, k, timg, tk = args
        args = (np.concatenate([img, timg], 1), np.concatenate([k, tk], 1),
                timg, tk)
        kwargs = {"context_valid": np.asarray([True, True, False])}
    jout = jax.jit(jenc.apply)(params, *args, **kwargs)
    with torch.no_grad():
        tout = tenc(*map(to_torch, args),
                    **{k: to_torch(v) for k, v in kwargs.items()})
    for name in ("pts3d", "depths", "extrinsics_cwt", "extrinsics_c",
                 "densities"):
        close(tout[name].numpy(), jout[name], msg=name)
    for name in ("means", "covariances", "scales", "rotations", "harmonics",
                 "opacities"):
        close(getattr(tout["gaussians"], name).numpy(),
              getattr(jout["gaussians"], name), msg=name)
    # Non-trivial poses: the random pose heads move the non-pivot views.
    assert np.abs(np.asarray(jout["extrinsics_cwt"])[0, 1]
                  - np.eye(4)).max() > 1e-2


def test_dpt_heads_run_head_conv1_off_cudnn(encoders):
    """The flagship DPT heads' float32 3x3 and 7x7 convolutions: the
    pointmap heads' `head_conv1` runs its forward with cuDNN off (cuDNN
    picks an FFT algorithm for it on the card), every other one with
    cuDNN as set (forward hooks record the flag), and the heads' outputs
    still equal the JAX heads'."""
    jenc, params, tenc, args = encoders
    seen, hooks = {}, []

    def record(name):
        def hook(module, inputs, output):
            seen.setdefault(name, torch.backends.cudnn.enabled)
        return hook

    for name, mod in tenc.named_modules():
        if name.startswith(("downstream_head", "gaussian_param_head")) and \
                isinstance(mod, torch.nn.Conv2d) and mod.kernel_size[0] >= 3 \
                and ".core." not in name:
            hooks.append(mod.register_forward_hook(record(name)))
    try:
        with torch.no_grad():
            tout = tenc(*map(to_torch, args))
    finally:
        for h in hooks:
            h.remove()
    assert torch.backends.cudnn.enabled
    off = {f"downstream_head{s}.head_conv1" for s in (1, 2)}
    assert set(seen) == off | {
        f"{head}{s}.{conv}" for s in (1, 2) for head, conv in (
            ("downstream_head", "head_conv2"),
            ("gaussian_param_head", "input_merger"),
            ("gaussian_param_head", "head_conv"))}
    assert {name for name, enabled in seen.items() if not enabled} == off
    jout = jax.jit(jenc.apply)(params, *args)
    for name in ("pts3d", "depths", "densities"):
        close(tout[name].numpy(), jout[name], msg=name)
    for name in ("means", "covariances", "harmonics", "opacities"):
        close(getattr(tout["gaussians"], name).numpy(),
              getattr(jout["gaussians"], name), msg=name)


def test_from_flax_layouts():
    rng = np.random.default_rng(3)
    tree = {"params": {
        "enc_blocks_3": {"norm1": {"scale": rng.standard_normal(4),
                                   "bias": rng.standard_normal(4)}},
        "dec_blocks2_0": {"mlp": {"fc1": {"kernel": rng.standard_normal((4, 6))}}},
        "head": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 5))}},
    }}
    sd = flax_to_state_dict(tree)
    p = tree["params"]
    assert set(sd) == {"enc_blocks.3.norm1.weight", "enc_blocks.3.norm1.bias",
                       "dec_blocks2.0.mlp.fc1.weight", "head.conv.weight"}
    np.testing.assert_array_equal(sd["dec_blocks2.0.mlp.fc1.weight"].numpy(),
                                  p["dec_blocks2_0"]["mlp"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["head.conv.weight"].numpy(),
        np.transpose(p["head"]["conv"]["kernel"], (3, 2, 0, 1)))
    assert tuple(sd["head.conv.weight"].shape) == (5, 2, 3, 3)


@pytest.mark.parametrize("block,dtype", [("encoder", "bfloat16"),
                                         ("decoder", "float32")])
def test_block_matches_jax(block, dtype):
    """One CroCo block.  bf16: the casts sit where JAX puts them (float32
    LayerNorms); bf16 rounds differently in the two frameworks, hence
    2e-2.  float32: the RTOL/ATOL bars."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 12, 32)).astype(np.float32)
    grid = lambda h, w: np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                             indexing="ij"), -1).reshape(1, h * w, 2)
    pos = grid(4, 5).repeat(2, 0).astype(np.int32)
    mpos = grid(3, 4).repeat(2, 0).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    if block == "encoder":
        jblk = jlayers.EncoderBlock(num_heads=4, compute_dtype=jdt)
        tblk = layers.EncoderBlock(32, 4, compute_dtype=tdt)
        jargs, targs = (xj, pos), (to_torch(x).to(tdt), to_torch(pos))
    else:
        jblk = jlayers.DecoderBlock(num_heads=4, compute_dtype=jdt)
        tblk = layers.DecoderBlock(32, 4, compute_dtype=tdt)
        jargs = (xj, jnp.asarray(mem), pos, mpos)
        targs = (to_torch(x).to(tdt), to_torch(mem), to_torch(pos),
                 to_torch(mpos))
    params = random_flax_params(jblk, 5, *jargs)
    jy = np.asarray(jblk.apply(params, *jargs).astype(jnp.float32))
    tblk.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        ty = tblk(*targs)
    assert ty.dtype == (tdt if block == "encoder" else torch.float32)
    tol = 2e-2 if dtype == "bfloat16" else ATOL
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=max(tol, RTOL),
                               atol=tol)


def test_se3_functions_match_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    d6 = rng.standard_normal((5, 6)).astype(np.float32)
    enc = rng.standard_normal((5, 9)).astype(np.float32)
    pts = rng.standard_normal((5, 7, 3)).astype(np.float32)
    close(se3.quaternion_to_matrix(to_torch(q)), jse3.quaternion_to_matrix(q))
    close(se3.rotation_6d_to_matrix(to_torch(d6)), jse3.rotation_6d_to_matrix(d6))
    poses = np.asarray(jse3.pose_encoding_to_matrix(enc))
    close(se3.pose_encoding_to_matrix(to_torch(enc)), poses)
    close(se3.inverse_se3(to_torch(poses)), jse3.inverse_se3(poses))
    close(se3.camera_normalization(to_torch(poses[:1]), to_torch(poses)),
          jse3.camera_normalization(poses[:1], poses))
    close(se3.depth_from_pose(to_torch(pts), to_torch(poses)),
          jse3.depth_from_pose(pts, poses))
    r = poses[:, :3, :3]
    close(se3.rotation_angle_deg(to_torch(r), to_torch(r[::-1].copy())),
          jse3.rotation_angle_deg(r, r[::-1]), atol=1e-3)
    t = poses[:, :3, 3]
    close(se3.translation_angle_deg(to_torch(t), to_torch(t[::-1].copy())),
          jse3.translation_angle_deg(t, t[::-1]), atol=1e-3)


def test_sh_and_adapter_match_jax():
    rng = np.random.default_rng(7)
    harm = rng.standard_normal((50, 3, 25)).astype(np.float32)
    dirs = rng.standard_normal((50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(eval_sh_colors(to_torch(harm), to_torch(dirs)), jeval_sh(harm, dirs))
    raw = rng.standard_normal((2, 40, 82)).astype(np.float32)
    means = rng.standard_normal((2, 40, 3)).astype(np.float32)
    pdf = rng.uniform(0, 1, (2, 40)).astype(np.float32)
    assert adapter.raw_gaussian_channels(4) == 83
    np.testing.assert_array_equal(adapter.sh_mask(4), jadapter.sh_mask(4))
    close(adapter.map_pdf_to_opacity(to_torch(pdf), 3, 0.5, 1.0, 10),
          jadapter.map_pdf_to_opacity(pdf, 3, 0.5, 1.0, 10))
    tg = adapter.unified_gaussian_adapter(to_torch(means), to_torch(pdf),
                                          to_torch(raw), sh_degree=4)
    jg = jadapter.unified_gaussian_adapter(means, pdf, raw, sh_degree=4)
    for name in ("means", "covariances", "scales", "rotations", "harmonics",
                 "opacities"):
        close(getattr(tg, name), getattr(jg, name), msg=name)


def test_rope_attention_and_resize_match_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, 2, 12, 8)).astype(np.float32)
               for _ in range(3))
    pos = rng.integers(0, 5, (1, 12, 2)).astype(np.int32)
    close(rope_2d(to_torch(q), to_torch(pos)), jrope(q, pos))
    close(attention.sdpa(*map(to_torch, (q, k, v)), 0.3),
          jattn.sdpa(q, k, v, 0.3))
    mask = np.asarray([[-np.inf, 0, 0], [0, -np.inf, 0], [0, 0, -np.inf]],
                      np.float32)
    close(attention.sdpa_view_masked(*map(to_torch, (q, k, v)), 0.3,
                                     to_torch(mask), 4),
          jattn.sdpa_view_masked(q, k, v, 0.3, mask, 4))
    # 4096 keys take the flash branch: K5 on CUDA tensors, the dense form
    # on CPU tensors.
    big = rng.standard_normal((1, 1, 4096, 4)).astype(np.float32)
    close(attention.sdpa(*map(to_torch, (big, big, big)), 0.5),
          jattn.sdpa(big, big, big, 0.5))
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    close(resize_bilinear(to_torch(x), (10, 14)), jresize(x, (10, 14)))


def test_seeded_init_is_reproducible_and_calibrated():
    """`build_encoder` on the CPU: same seed, same weights; the output
    layers start where the flax initializers put them."""
    from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu_torch.models import build_encoder
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
    from torch_port_common import TINY_BACKBONE, TINY_HEADS

    cfg = SPFSplatV2Config(backbone=CrocoBackboneConfig(**TINY_BACKBONE),
                           **TINY_HEADS)
    a = build_encoder(cfg, seed=3, device="cpu")
    b = build_encoder(cfg, seed=3, device="cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    torch.testing.assert_close(a.downstream_head1.head_out.bias,
                               torch.tensor([0.0, 0.0, 1.2]))
    assert a.pose_head2.fc_rot.bias.tolist() == [1.0, 0, 0, 0, 1.0, 0]
    rng = np.random.default_rng(0)
    img = to_torch(rng.uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32))
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).expand(1, 3, 3, 3)
    with torch.no_grad():
        out = a(img[:, :2], k[:, :2], img[:, 2:], k[:, 2:])
    assert torch.isfinite(out["gaussians"].means).all()
    torch.testing.assert_close(out["extrinsics_cwt"][0],
                               torch.eye(4).expand(3, 4, 4))
    # Points start in front of the cameras, near z = expm1(1.2) ~ 2.3.
    assert 1.0 < float(out["pts3d"][..., 2].median()) < 4.0
