"""PyTorch port's VGGT-1B encoder (`spfsplatv2l`) and its parts vs the JAX
package on the CPU.

The same numpy params go through the flax modules and, moved by
`utils/from_flax.py`, through the port's modules, at the tiny sizes of
the JAX package's tests/test_vggt.py (DINOv2 depth 1, aggregator depth 2,
width 32, 2 heads; camera head width 64, trunk depth 1).  Float32
compute is held at RTOL / ATOL; bfloat16 compute at BF16_TOL x the
largest magnitude, since bf16 rounds differently in the two frameworks
(JAX's dense layers and GELU round at other points than torch's).
"""

import functools
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.models.vggt import aggregator as jagg
from spfsplatv2_tpu.models.vggt import camera_head as jcam
from spfsplatv2_tpu.models.vggt import dinov2 as jdino
from spfsplatv2_tpu.models.vggt import dpt_head as jdpt
from spfsplatv2_tpu.models.vggt import layers as jlayers
from spfsplatv2_tpu.utils.ckpt_convert_vggt import (
    convert_vggt_checkpoint as jconvert,
)
from spfsplatv2_tpu_torch.models.vggt import aggregator, camera_head, dinov2
from spfsplatv2_tpu_torch.models.vggt import dpt_head, layers
from spfsplatv2_tpu_torch.ops import attention
from spfsplatv2_tpu_torch.utils.ckpt_convert_vggt import convert_vggt_checkpoint
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict
from spfsplatv2_tpu_torch.utils.interp import resize_bicubic

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    TINY_AGG,
    TINY_CAMERA,
    TINY_DINO,
    jax_tiny_vggt,
    random_flax_params,
    to_torch,
    torch_tiny_vggt,
    torch_tiny_vggt_config,
)

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 1e-2
HW = 28  # 2 x 2 patches of 14


def close(actual, desired, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=rtol, atol=atol, err_msg=msg)


def loaded(module, params):
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.eval()


def grid_pos(b, h, w, special=0):
    """(b, special + h*w, 2) int32: special tokens at 0, the grid at + 1."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.concatenate([np.zeros((special, 2)),
                          np.stack([yy.ravel(), xx.ravel()], -1) + 1])
    return np.broadcast_to(pos, (b, *pos.shape)).astype(np.int32).copy()


def images(seed, b, v, h=HW, w=HW):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32)
    k = np.asarray([[1.0, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32)
    return img, np.broadcast_to(k, (b, v, 3, 3)).copy()


@pytest.mark.parametrize("mask,dtype", [
    ("none", "float32"), ("tuple", "float32"), ("dense", "float32"),
    ("none", "bfloat16"), ("tuple", "bfloat16")])
def test_block_matches_jax(mask, dtype):
    """qk-norm + RoPE + LayerScale block, unmasked (frame attention),
    tuple-masked (global attention) and dense-masked (the camera trunk)."""
    rng = np.random.default_rng(1)
    b, v, l, c = 2, 3, 6, 32
    x = rng.standard_normal((b, v * l, c)).astype(np.float32)
    pos = np.tile(grid_pos(b, 2, 2, special=2), (1, v, 1))
    view_mask = np.asarray(jagg.global_view_mask_blocks(v, 1))
    if mask == "none":
        jm = tm = None
    elif mask == "tuple":
        jm, tm = (view_mask, l), (to_torch(view_mask), l)
    else:
        # A dropped view's key column: -inf for every row.
        dense = np.where(np.arange(v * l)[None, :] // l == 1, -np.inf,
                         0.0).repeat(v * l, 0).astype(np.float32)
        jm, tm = dense, to_torch(dense)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jblk = jlayers.VGGTBlock(num_heads=2, compute_dtype=jdt)
    params = random_flax_params(jblk, 2, x, pos)
    jy = np.asarray(jax.jit(functools.partial(jblk.apply, mask=jm))(
        params, x, pos), np.float32)
    tblk = loaded(layers.VGGTBlock(c, 2, compute_dtype=tdt), params)
    with torch.no_grad():
        ty = tblk(to_torch(x), to_torch(pos), tm).numpy()
    if dtype == "float32":
        close(ty, jy)
    else:
        close(ty, jy, rtol=0, atol=BF16_TOL * np.abs(jy).max())


@pytest.mark.parametrize("grid,out", [(37, 16), (37, 40), (37, 64), (4, 2),
                                      (37, (16, 23))])
def test_bicubic_resize_matches_jax(grid, out):
    """The position embedding's resize: torch's antialiased bicubic is
    jax.image.resize's bicubic, shrinking and growing."""
    out = out if isinstance(out, tuple) else (out, out)
    x = np.random.default_rng(3).standard_normal((1, grid, grid, 8)).astype(
        np.float32)
    close(resize_bicubic(to_torch(x), out),
          jax.image.resize(x, (1, *out, 8), "bicubic"), atol=2e-6)


def test_dinov2_matches_jax_at_a_non_native_grid():
    """2 x 3 patches against the 4 x 4 position grid."""
    cfg = TINY_DINO
    img = np.random.default_rng(4).standard_normal((2, 28, 42, 3)).astype(
        np.float32)
    jmod = jdino.DinoV2(jdino.DinoV2Config(**cfg))
    params = random_flax_params(jmod, 5, img)
    tmod = loaded(dinov2.DinoV2(dinov2.DinoV2Config(**cfg)), params)
    with torch.no_grad():
        ty = tmod(to_torch(img))
    assert tuple(ty.shape) == (2, 6, 32)
    close(ty, jax.jit(jmod.apply)(params, img))


@pytest.mark.parametrize("case", ["with_target", "view_valid",
                                  "context_only"])
def test_aggregator_matches_jax(case):
    img, k = images(6, 1, 3)
    num_target, valid = 1, None
    if case == "context_only":
        num_target = 0
    if case == "view_valid":
        valid = np.asarray([1.0, 0.0, 1.0], np.float32)
    cfg = TINY_AGG
    jcfg = jagg.AggregatorConfig(**cfg, dinov2=jdino.DinoV2Config(**TINY_DINO))
    jmod = jagg.VGGTAggregator(jcfg)
    params = random_flax_params(jmod, 7, img, k)
    jout = jax.jit(functools.partial(jmod.apply, num_target=num_target))(
        params, img, k, view_valid=valid)
    tmod = loaded(aggregator.VGGTAggregator(aggregator.AggregatorConfig(
        **cfg, dinov2=dinov2.DinoV2Config(**TINY_DINO))), params)
    with torch.no_grad():
        tout = tmod(to_torch(img), to_torch(k), num_target,
                    None if valid is None else to_torch(valid))
    assert tout["patch_start"] == jout["patch_start"] == 4
    assert tout["grid"] == tuple(jout["grid"]) == (2, 2)
    assert len(tout["tokens"]) == 2
    for i, (t, j) in enumerate(zip(tout["tokens"], jout["tokens"])):
        assert t.dtype == torch.float32 and tuple(t.shape) == (1, 3, 8, 64)
        close(t, j, msg=f"layer {i}")


@pytest.mark.parametrize("num_target,valid", [(1, None), (0, None),
                                              (2, [True, False, True, True])])
def test_global_view_mask_matches_jax(num_target, valid):
    v = 4
    jm = jagg.global_view_mask_blocks(
        v, num_target, None if valid is None else np.asarray(valid))
    tm = aggregator.global_view_mask_blocks(
        v, num_target, None if valid is None else torch.tensor(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("valid", [None, [1.0, 0.0, 1.0, 1.0]])
def test_camera_head_matches_jax(valid):
    """The 4-iteration refinement; with `view_valid` the trunk's dense
    masked branch (a dropped view's key column is -inf for every row)."""
    rng = np.random.default_rng(8)
    tokens = rng.standard_normal((2, 4, 64)).astype(np.float32)
    valid = None if valid is None else np.asarray(valid, np.float32)
    jmod = jcam.CameraHead(jcam.CameraHeadConfig(**TINY_CAMERA))
    params = random_flax_params(jmod, 9, tokens, valid)
    jenc = np.asarray(jax.jit(jmod.apply)(params, tokens, valid))
    tmod = loaded(camera_head.CameraHead(
        camera_head.CameraHeadConfig(**TINY_CAMERA)), params)
    with torch.no_grad():
        tenc = tmod(to_torch(tokens), None if valid is None else to_torch(valid))
    close(tenc, jenc)
    assert bool((tenc[..., 7:] >= 0).all())
    close(camera_head.pose_encoding_to_w2c(tenc), jcam.pose_encoding_to_w2c(jenc))
    close(camera_head.fov_to_intrinsics(tenc), jcam.fov_to_intrinsics(jenc))
    # The encoding's rotations are not the identity: the quaternion's
    # vector part is exercised.
    assert np.abs(np.asarray(jcam.pose_encoding_to_w2c(jenc))[..., :3, :3]
                  - np.eye(3)).max() > 1e-2


def test_pose_encoding_round_trip():
    """Identity rotation (xyzw [0, 0, 0, 1]), translation [1, 2, 3]."""
    enc = torch.tensor([[[1.0, 2, 3, 0, 0, 0, 1, 0.9, 0.9]]])
    w2c = camera_head.pose_encoding_to_w2c(enc)
    torch.testing.assert_close(w2c[0, 0, :3, :3], torch.eye(3))
    torch.testing.assert_close(w2c[0, 0, :3, 3], torch.tensor([1.0, 2, 3]))
    k = camera_head.fov_to_intrinsics(enc)
    np.testing.assert_allclose(float(k[0, 0, 0, 0]), 0.5 / np.tan(0.45),
                               rtol=1e-6)
    assert float(k[0, 0, 0, 2]) == 0.5


@pytest.mark.parametrize("gs", [False, True])
def test_dpt_head_matches_jax(gs):
    """Both variants on 3 layers of (b, v, 4 + 2 x 3 patches, 64) tokens
    at a non-square grid (the uv embedding's aspect)."""
    rng = np.random.default_rng(10)
    b, v, gh, gw = 1, 2, 2, 3
    toks = [rng.standard_normal((b, v, 4 + gh * gw, 64)).astype(np.float32)
            for _ in range(3)]
    img = rng.uniform(0, 1, (b, v, 14 * gh, 14 * gw, 3)).astype(np.float32)
    # The GS skip is 128 wide, features // 2 in the presets.
    kw = dict(features=256, out_channels=(8, 16, 24, 24))
    out_dim = 20 if gs else 4
    jmod = jdpt.VGGTDPTHead(output_dim=out_dim, gs_variant=gs, **kw)
    static = dict(grid=(gh, gw), patch_start=4, images=img if gs else None)
    params = random_flax_params(jmod, 11, toks, **static)
    jout = jax.jit(functools.partial(jmod.apply, **static))(params, toks)
    tmod = loaded(dpt_head.VGGTDPTHead(64, output_dim=out_dim, gs_variant=gs,
                                       **kw), params)
    with torch.no_grad():
        tout = tmod([to_torch(t) for t in toks], (gh, gw), 4,
                    to_torch(img) if gs else None)
    if gs:
        assert tuple(tout.shape) == (b, v, 28, 42, 20)
        close(tout, jout)
    else:
        close(tout[0], jout[0], msg="pts3d")
        close(tout[1], jout[1], msg="conf")
        assert bool((tout[1] > 1).all())
    assert dpt_head.vggt_hooks(24) == jdpt.vggt_hooks(24) == (4, 11, 17, 23)
    assert dpt_head.vggt_hooks(3) == jdpt.vggt_hooks(3)
    close(dpt_head.uv_pos_embed(5, 7, 16, 1.4), jdpt.uv_pos_embed(5, 7, 16, 1.4),
          atol=1e-6)


@pytest.fixture(scope="module")
def encoders():
    img, k = images(12, 1, 4)
    jenc = jax_tiny_vggt()
    args = (img[:, :3], k[:, :3], img[:, 3:], k[:, 3:])
    params = random_flax_params(jenc, 13, *args)
    return jenc, params, args


@pytest.mark.parametrize("case", ["with_target", "context_only",
                                  "context_valid", "target_valid"])
def test_encoder_matches_jax(encoders, case):
    """Every key of the output dict; with `context_valid` a dropped context
    view, with `target_valid` a dropped target view."""
    jenc, params, args = encoders
    kwargs = {}
    if case == "context_only":
        args = args[:2]
    elif case == "context_valid":
        kwargs = {"context_valid": np.asarray([True, False, True])}
    elif case == "target_valid":
        img, k, timg, tk = args
        args = (img[:, :2], k[:, :2], np.concatenate([img[:, 2:], timg], 1),
                np.concatenate([k[:, 2:], tk], 1))
        kwargs = {"target_valid": np.asarray([True, False])}
    jout = jax.jit(jenc.apply)(params, *args, **kwargs)
    tenc = torch_tiny_vggt(params)
    with torch.no_grad():
        tout = tenc(*map(to_torch, args),
                    **{key: to_torch(v) for key, v in kwargs.items()})
    assert set(tout) == set(jout)
    for name in ("pts3d", "pts3d_conf", "depths", "extrinsics_cwt",
                 "extrinsics_c", "densities"):
        close(tout[name], jout[name], msg=name)
    for name in ("means", "covariances", "scales", "rotations", "harmonics",
                 "opacities"):
        close(getattr(tout["gaussians"], name),
              getattr(jout["gaussians"], name), msg=name)
    if case == "context_valid":
        assert float(tout["gaussians"].opacities.reshape(1, 3, -1)[:, 1].abs()
                     .max()) == 0.0
    # Non-trivial poses: the random camera head moves the non-pivot views.
    assert np.abs(np.asarray(jout["extrinsics_cwt"])[0, 1] - np.eye(4)).max() > 1e-2


def test_encoder_bf16_matches_jax(encoders):
    """bf16 compute in the aggregator and DINOv2 (float32 LayerNorms,
    camera trunk and heads), as the presets run it."""
    jenc32, params, args = encoders
    jenc = jax_tiny_vggt("bfloat16")
    jout = jax.jit(jenc.apply)(params, *args)
    tenc = torch_tiny_vggt(params, "bfloat16")
    with torch.no_grad():
        tout = tenc(*map(to_torch, args))
    for name in ("pts3d", "depths", "extrinsics_cwt", "densities"):
        ref = np.asarray(jout[name])
        close(tout[name], ref, rtol=0, atol=BF16_TOL * np.abs(ref).max(),
              msg=name)


def test_aggregator_names_k5_limits(monkeypatch):
    """The aggregator and DINOv2 raise before any computation when a
    per-view self-attention would hand K5 on CUDA tensors (here
    pretended) heads other than 64 wide or a dtype that no K5 kernel
    takes (float16), reading FLASH_MIN_KV at call time as sdpa does; bf16
    and float32 with 64-wide heads reach the computation."""
    from spfsplatv2_tpu_torch.models.vggt import dinov2 as tdino

    real = attention.flash_limits_violation
    monkeypatch.setattr(tdino, "flash_limits_violation",
                        lambda device, *a: real(torch.device("cuda"), *a))
    img = torch.zeros(1, 2, 28, 28, 3)
    k = torch.eye(3).expand(1, 2, 3, 3)
    cfg = dict(TINY_AGG, embed_dim=128)   # 64-wide heads
    dino = dict(TINY_DINO, embed_dim=128)
    # 2 x 2 patches: 8 frame tokens a view (intrinsics, camera, 2
    # registers, 4 patches), 7 DINOv2 tokens (cls, 2 registers, 4).
    for agg_over, dino_over, min_kv, where in (
            ({"embed_dim": 64}, {}, 6, "AggregatorConfig"),     # 32-wide
            ({"compute_dtype": "float16"}, {}, 8, "AggregatorConfig"),
            ({}, {"embed_dim": 64}, 7, "DinoV2Config"),
            ({}, {"compute_dtype": "float16"}, 7, "DinoV2Config")):
        model = aggregator.VGGTAggregator(aggregator.AggregatorConfig(
            **{**cfg, **agg_over},
            dinov2=dinov2.DinoV2Config(**{**dino, **dino_over})))
        monkeypatch.setattr(attention, "FLASH_MIN_KV", min_kv)
        with pytest.raises(ValueError, match=where) as err:
            model(img, k, num_target=1)
        assert "head dim 64" in str(err.value)
    # bf16 and float32 with 64-wide heads take K5 (dense here, on the
    # CPU), as does everything below the threshold.
    monkeypatch.setattr(attention, "FLASH_MIN_KV", 7)
    for dtype in ("bfloat16", "float32"):
        over = {"compute_dtype": dtype}
        model = aggregator.VGGTAggregator(aggregator.AggregatorConfig(
            **{**cfg, **over}, dinov2=dinov2.DinoV2Config(**{**dino, **over})))
        with torch.no_grad():
            assert len(model(img, k, num_target=1)["tokens"]) == 2


# The reference module names of the port's parameters (the inverse of
# the converter's table), to build reference state dicts.
_TO_REFERENCE = [
    (r"^aggregator\.patch_embed\.patch_embed\.", "aggregator.patch_embed.patch_embed.proj."),
    (r"\.mlp_fc(\d)\.", r".mlp.fc\1."),
    (r"^camera_head\.poseLN_modulation\.", "camera_head.poseLN_modulation.1."),
    (r"^camera_head\.pose_branch_fc(\d)\.", r"camera_head.pose_branch.fc\1."),
    (r"\.projects_(\d)\.", r".projects.\1."),
    (r"\.resize_(\d)\.", r".resize_layers.\1."),
    (r"_head\.(layer\d_rn|refinenet\d|output_conv1)\.", r"_head.scratch.\1."),
    (r"_head\.output_conv2_(\d)\.", r"_head.scratch.output_conv2.\1."),
    (r"\.input_merger\.", ".input_merger.0."),
]


def test_convert_vggt_checkpoint_matches_jax():
    """A random state dict under the reference's names (with a "model."
    prefix, a track head, a depth head and DINOv2's mask token, which are
    dropped): the port's converter gives, key for key and array for
    array, JAX's converter followed by `flax_to_state_dict`, and the
    result loads into the port's encoder."""
    from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LEncoder

    enc = SPFSplatV2LEncoder(torch_tiny_vggt_config(trunk_depth=4))
    rng = np.random.default_rng(14)
    ref = {}
    for key, t in enc.state_dict().items():
        for pat, rep in _TO_REFERENCE:
            key = re.sub(pat, rep, key)
        value = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        if key in ("aggregator.camera_token", "aggregator.register_token"):
            value = value[None]
        ref["model." + key] = value
    for extra, shape in (("track_head.fnet.weight", (4, 3)),
                         ("depth_head.norm.weight", (64,)),
                         ("aggregator.patch_embed.mask_token", (1, 32))):
        ref["model." + extra] = rng.standard_normal(shape).astype(np.float32)

    want = flax_to_state_dict(jconvert(ref, depth=2, dinov2_depth=1))
    got = convert_vggt_checkpoint({k: torch.from_numpy(v) for k, v in ref.items()},
                                  depth=2, dinov2_depth=1)
    assert set(got) == set(want) == set(enc.state_dict())
    for key, value in want.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), key)
    enc.load_state_dict(got, strict=True)


def test_seeded_init_is_reproducible_and_follows_flax():
    """`build_encoder` on the CPU: same seed, same weights; the tokens,
    LayerScales and output convs start where the flax initializers put
    them."""
    from spfsplatv2_tpu_torch.models import build_encoder

    cfg = torch_tiny_vggt_config()
    a = build_encoder(cfg, seed=3, device="cpu")
    b = build_encoder(cfg, seed=3, device="cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    agg = a.aggregator
    assert 1e-7 < float(agg.camera_token.detach().abs().max()) < 1e-5
    assert float(agg.patch_embed.pos_embed.detach().std()) == pytest.approx(
        0.02, rel=0.1)
    assert not agg.patch_embed.cls_token.any()
    assert not agg.patch_embed.register_tokens.any()
    assert not a.camera_head.empty_pose_tokens.any()
    assert bool((agg.frame_blocks[0].ls1.gamma == 0.01).all())
    assert bool((agg.patch_embed.blocks[0].ls2.gamma == 1.0).all())
    gs = a.gaussian_param_head.output_conv2_2.weight
    pts = a.point_head.output_conv2_2.weight
    assert 5 < float(pts.std() / gs.std()) < 20   # 0.01 of the variance
    img, k = images(15, 1, 3)
    with torch.no_grad():
        out = a(to_torch(img[:, :2]), to_torch(k[:, :2]), to_torch(img[:, 2:]),
                to_torch(k[:, 2:]))
    assert all(bool(torch.isfinite(out[key]).all())
               for key in ("pts3d", "pts3d_conf", "extrinsics_cwt"))
    torch.testing.assert_close(out["extrinsics_cwt"][0, 0], torch.eye(4))
