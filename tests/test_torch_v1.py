"""The port's SPFSplat v1 family vs the JAX package on the CPU.

The unmasked multi-view backbone (both decoder passes), the v1 encoder
(Gaussians, points, both pose sets, the estimated focal), the ManyAR
patch embed on a mixed portrait/landscape batch, focal estimation, the
camera embeddings and the v1 `compute_losses` with its gradients, on the
tiny sizes of tests/test_registry_wiring.py (2 encoder and 2 decoder
blocks, widths 64/48, 32x32) with the same numpy weights on both sides.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.geometry import camera_emb as jcamera_emb
from spfsplatv2_tpu.geometry import intrinsics as jintrinsics
from spfsplatv2_tpu.models.croco import backbone as jbackbone
from spfsplatv2_tpu.models.croco import backbone_multi as jmulti
from spfsplatv2_tpu.models.croco.layers import ManyARPatchEmbed as JManyAR
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.models.encoder_spfsplat import SPFSplatConfig as JConfig
from spfsplatv2_tpu.models.encoder_spfsplat import SPFSplatEncoder as JEncoder
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu.training import step as jstep
from spfsplatv2_tpu_torch.geometry import camera_emb, intrinsics
from spfsplatv2_tpu_torch.losses import reproj
from spfsplatv2_tpu_torch.models.croco import backbone, backbone_multi
from spfsplatv2_tpu_torch.models.croco.layers import ManyARPatchEmbed
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.models.encoder_spfsplat import (
    SPFSplatConfig,
    SPFSplatEncoder,
)
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig
from spfsplatv2_tpu_torch.training import step
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import make_batch, torch_batch  # noqa: E402
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    TINY_BACKBONE,
    TINY_HEADS,
    random_flax_params,
    to_torch,
)

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
HW = (32, 32)
GLOBAL_STEP = 1000
# tests/test_registry_wiring.py's TINY_BB (patch 16), float32 compute.
MULTI_BB = {k: v for k, v in TINY_BACKBONE.items()}


def close(actual, desired, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=rtol, atol=atol, err_msg=msg)


def jax_v1(**cfg):
    return JEncoder(JConfig(backbone=jmulti.CrocoMultiBackboneConfig(
        **MULTI_BB, remat=False), **TINY_HEADS, **cfg))


def torch_v1(params, **cfg):
    enc = SPFSplatEncoder(SPFSplatConfig(
        backbone=backbone_multi.CrocoMultiBackboneConfig(**MULTI_BB),
        **TINY_HEADS, **cfg))
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    return enc.eval()


def jitted_apply(module):
    """`module.apply`, jitted, without the v1 encoder's "variant" string
    (not an array)."""
    return jax.jit(lambda *a: {k: v for k, v in module.apply(*a).items()
                               if k != "variant"})


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 3, *HW, 3)).astype(np.float32)
    k = np.broadcast_to(np.asarray([[1.0, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]],
                                   np.float32), (1, 3, 3, 3)).copy()
    return img[:, :2], k[:, :2], img[:, 2:], k[:, 2:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_backbone_matches_jax(inputs, dtype):
    """Both decoder passes, every layer: the context-only pass and the
    pass over all views (targets included).  bf16 rounds differently in
    the two frameworks, hence 2e-2 of each layer's max there."""
    img, k, timg, tk = inputs
    images = np.concatenate([img, timg], 1) * 2.0 - 1.0
    intr = np.concatenate([k, tk], 1)
    cfg = {**MULTI_BB, "compute_dtype": dtype}
    jbb = jmulti.CrocoMultiBackbone(jmulti.CrocoMultiBackboneConfig(
        **cfg, remat=False))
    params = random_flax_params(jbb, 2, images, intr, num_target=1)
    jout = jax.jit(lambda p, x, kk: jbb.apply(p, x, kk, num_target=1))(
        params, images, intr)
    tbb = backbone_multi.CrocoMultiBackbone(
        backbone_multi.CrocoMultiBackboneConfig(**cfg))
    tbb.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        tout = tbb(to_torch(images), to_torch(intr), num_target=1)
    assert tout["grid"] == tuple(jout["grid"]) == (2, 2)
    for key, v in (("dec_feat", 2), ("dec_feat_w_tgt", 3)):
        assert len(tout[key]) == len(jout[key]) == MULTI_BB["dec_depth"] + 1
        for i, (a, b) in enumerate(zip(tout[key], jout[key])):
            assert a.dtype == torch.float32 and a.shape == (1, v, 4, a.shape[-1])
            if dtype == "bfloat16":
                close(a.numpy(), b, rtol=0,
                      atol=BF16_TOL * float(np.abs(b).max()), msg=f"{key}[{i}]")
            else:
                close(a.numpy(), b, msg=f"{key}[{i}]")
    # The two passes attend to different view sets.
    assert np.abs(np.asarray(jout["dec_feat"][-1])
                  - np.asarray(jout["dec_feat_w_tgt"][-1])[:, :2]).max() > 1e-3


@pytest.fixture(scope="module")
def v1_params(inputs):
    return random_flax_params(jax_v1(), 1, *inputs)


@pytest.mark.parametrize("case", ["with_target", "context_only"])
def test_v1_encoder_matches_jax(inputs, v1_params, case):
    """With a target (and `estimating_focal`: view 0's focal for all
    views), and over the context views alone."""
    cfg = {"estimating_focal": True} if case == "with_target" else {}
    args = inputs[:2] if case == "context_only" else inputs
    jenc, params = jax_v1(**cfg), v1_params
    jout = jitted_apply(jenc)(params, *args)
    with torch.no_grad():
        tout = torch_v1(params, **cfg)(*map(to_torch, args))
    assert tout["variant"] == "spfsplat"
    names = ["pts3d", "depths", "extrinsics_c", "extrinsics_cwt", "densities"]
    if case == "with_target":
        names.append("intrinsics_cwt")
        assert tout["intrinsics_cwt"].shape == (1, 3, 3, 3)
    for name in names:
        close(tout[name].numpy(), jout[name], msg=name)
    for name in ("means", "covariances", "scales", "rotations", "harmonics",
                 "opacities"):
        close(getattr(tout["gaussians"], name).numpy(),
              getattr(jout["gaussians"], name), msg=name)
    if case == "context_only":
        assert torch.equal(tout["extrinsics_c"], tout["extrinsics_cwt"])
    else:
        # The pass with the target gives other context poses.
        assert np.abs(np.asarray(jout["extrinsics_c"])
                      - np.asarray(jout["extrinsics_cwt"])[:, :2]).max() > 1e-4
    # Baseline 1 between views 0 and 1 of the context-only pass.
    close(np.linalg.norm(tout["extrinsics_c"][0, 1, :3, 3].numpy()), 1.0)


def test_manyar_patch_embed_and_backbone_match_jax():
    """A mixed batch: two landscape images and two portrait ones (stored
    transposed in the landscape buffer), through the embed alone and
    through the masked backbone with `true_shapes`."""
    rng = np.random.default_rng(3)
    h, w, p, dim = 32, 48, 16, 64
    img = rng.standard_normal((4, h, w, 3)).astype(np.float32)
    shapes = np.asarray([[h, w], [w, h], [h, w], [w, h]], np.int32)
    jemb = JManyAR(p, dim, jnp.float32)
    params = random_flax_params(jemb, 0, img, shapes)
    jx, jpos = jemb.apply(params, img, shapes)
    temb = ManyARPatchEmbed(p, dim, torch.float32)
    temb.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        tx, tpos = temb(to_torch(img), to_torch(shapes))
    close(tx.numpy(), jx)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert not np.array_equal(np.asarray(jpos[0]), np.asarray(jpos[1]))

    cfg = dict(enc_depth=1, enc_embed_dim=64, enc_num_heads=4, dec_depth=1,
               dec_embed_dim=48, dec_num_heads=4, patch_embed_cls="manyar",
               intrinsics_token=False, compute_dtype="float32")
    jbb = jbackbone.MaskedCrocoBackbone(jbackbone.CrocoBackboneConfig(
        **cfg, remat=False))
    views = img.reshape(1, 4, h, w, 3)
    vshapes = shapes.reshape(1, 4, 2)
    params = random_flax_params(jbb, 1, views, num_target=1,
                                true_shapes=vshapes)
    jout = jax.jit(lambda p, x, ts: jbb.apply(p, x, num_target=1,
                                              true_shapes=ts))(
        params, views, vshapes)
    tbb = backbone.MaskedCrocoBackbone(backbone.CrocoBackboneConfig(**cfg))
    tbb.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        tout = tbb(to_torch(views), num_target=1,
                   true_shapes=to_torch(vshapes))
    for i, (a, b) in enumerate(zip(tout["dec_feat"], jout["dec_feat"])):
        close(a.numpy(), b, msg=f"dec_feat[{i}]")
        assert a.shape == (1, 4, 6, a.shape[-1])


def test_focal_estimation_matches_jax():
    """Weiszfeld focal on pinhole pointmaps with noise, points behind the
    camera and a view whose initial estimate is negative (the 60-degree
    fallback)."""
    rng = np.random.default_rng(4)
    h, w = 12, 16
    ys, xs = np.meshgrid(np.arange(h) - h / 2, np.arange(w) - w / 2,
                         indexing="ij")
    pts = []
    for f in (20.0, 35.0, -10.0):
        z = rng.uniform(1, 5, (h, w))
        p = np.stack([xs * z / f, ys * z / f, z], -1)
        pts.append(p + 0.01 * rng.standard_normal(p.shape))
    pts = np.stack(pts).astype(np.float32)
    pts[0, 0, :3, 2] = -1.0
    jf = jintrinsics.estimate_focal_from_pointmap(pts)
    tf = intrinsics.estimate_focal_from_pointmap(to_torch(pts))
    close(tf.numpy(), jf, rtol=1e-5)
    np.testing.assert_allclose(tf[:2].numpy(), [20.0, 35.0], rtol=0.05)
    views = np.stack([pts, pts[::-1]], 1)
    close(intrinsics.estimate_intrinsics(to_torch(views)).numpy(),
          jintrinsics.estimate_intrinsics(views), rtol=1e-5)


def test_camera_embeddings_match_jax():
    rng = np.random.default_rng(5)
    k = np.stack([CAMERA_K, CAMERA_K * np.asarray([[1.2], [0.9], [1.0]],
                                                  np.float32)])
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[:, :3, 3] = rng.standard_normal((2, 3))
    hw = (6, 8)
    for degree in (0, 2, 4):
        close(camera_emb.get_intrinsic_embedding(to_torch(k), hw, degree).numpy(),
              jcamera_emb.get_intrinsic_embedding(k, hw, degree), msg=str(degree))
    close(camera_emb.get_intrinsic_positional_embedding(to_torch(k), hw, 32).numpy(),
          jcamera_emb.get_intrinsic_positional_embedding(k, hw, 32))
    tp = camera_emb.get_plucker_embedding(to_torch(c2w), to_torch(k), hw)
    assert tp.shape == (2, 6, 8, 6)
    close(tp.numpy(), jcamera_emb.get_plucker_embedding(c2w, k, hw))


def test_reproj_detach_pts3d_blocks_point_gradients():
    rng = np.random.default_rng(6)
    pts = np.concatenate([rng.uniform(-1, 1, (1, 4, 4, 2)),
                          rng.uniform(1, 3, (1, 4, 4, 1))], -1).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[None]
    c2w[0, :3, 3] = [0.05, -0.02, 0.01]
    k = CAMERA_K[None]
    grads = {}
    for detach in (False, True):
        tp = to_torch(pts).requires_grad_(True)
        tc = to_torch(c2w).requires_grad_(True)
        loss = reproj.reproj_loss(tp, tc, to_torch(k), 0, detach_pts3d=detach)
        loss.backward()
        grads[detach] = (loss.detach(), tp.grad, tc.grad)
    assert torch.equal(grads[True][0], grads[False][0])
    assert grads[True][1] is None and grads[False][1].abs().max() > 0
    assert torch.equal(grads[True][2], grads[False][2])


def test_v1_compute_losses_and_grads_match_jax():
    """The v1 loss (MSE, reprojection with the pass with targets, and the
    pose-only term on the context-only pass with detached points) and its
    gradients, b = 2, against JAX's at the same weights through its dense
    oracle rasterizer, gradients within 1e-4 of each max."""
    batch = make_batch(7)
    c, t = batch["context"], batch["target"]
    jenc = jax_v1()
    params = random_flax_params(jenc, 3, c["image"], c["intrinsics"],
                                t["image"], t["intrinsics"])
    jdcfg = JDecoderConfig(rasterizer=JRasterizerConfig(
        backend="reference", entry_budget_factor=4.0, chunk=64))
    loss_cfg = dict(use_lpips=False)

    def loss_fn(p):
        return jstep.compute_losses(jenc, p, batch, GLOBAL_STEP, HW, jdcfg,
                                    jstep.LossConfig(**loss_cfg))

    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    tenc = torch_v1(params)
    tenc.train()
    loss, tmetrics = step.compute_losses(
        tenc, torch_batch(batch), GLOBAL_STEP, HW,
        DecoderConfig(rasterizer=RasterizerConfig(entry_budget_factor=4.0,
                                                  chunk=64)),
        step.LossConfig(**loss_cfg))
    loss.backward()
    assert set(tmetrics) == set(jmetrics)
    assert float(tmetrics["loss/reproj_c2_only"]) > 0
    for key, ref in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[key]), float(ref),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    tgrads = dict(tenc.named_parameters())
    jflat = flax_to_state_dict(jgrads)
    assert set(jflat) == set(tgrads)
    for name, ref in jflat.items():
        got = tgrads[name].grad
        assert got is not None and torch.isfinite(got).all(), name
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=1e-4 * scale + 1e-12, err_msg=name)
    # v1 takes no view-dropout masks, in JAX and in the port.
    masked = {**torch_batch(batch),
              "context_valid": torch.ones(2, dtype=torch.bool)}
    with pytest.raises(TypeError, match="context_valid"):
        step.compute_losses(tenc, masked, GLOBAL_STEP, HW,
                            loss_cfg=step.LossConfig(**loss_cfg))
    with pytest.raises(TypeError, match="context_valid"):
        jstep.compute_losses(jenc, params, {**batch, "context_valid":
                                            np.ones(2, bool)}, GLOBAL_STEP,
                             HW, jdcfg, jstep.LossConfig(**loss_cfg))


def test_v1_config_builds_through_registry():
    """`encoder.name=spfsplat` with overrides builds the v1 encoder with
    the preset's pose heads (homogeneous, un-zeroed fc_t)."""
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.models import get_encoder

    ov = ["encoder.name=spfsplat"] + [
        f"encoder.spfsplat.backbone.{k}={v}" for k, v in MULTI_BB.items()] + [
        f"encoder.spfsplat.{k}={list(v) if isinstance(v, tuple) else v}"
        for k, v in TINY_HEADS.items()]
    cfg = load_config(None, ov)
    enc = get_encoder(cfg.encoder, seed=3, device="cpu")
    assert isinstance(enc, SPFSplatEncoder)
    assert enc.pose_head1.mlp1.in_features == 64 + 48
    assert enc.pose_head1.fc_t.out_features == 4
    assert enc.pose_head1.fc_t.weight.abs().max() > 0
    again = get_encoder(cfg.encoder, seed=3, device="cpu").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in enc.state_dict().items())
    assert dataclasses.asdict(cfg.encoder.spfsplat)["pose_head"]["init_t"] is False


def test_evaluate_example_renders_with_estimated_focal(inputs, v1_params):
    """`use_estimated_focal` renders the target with the encoder's
    estimated intrinsics in place of the given ones (JAX's evaluator
    cannot serve v1: it jits `apply`, whose "variant" string is no array;
    the estimated intrinsics themselves are held against JAX above)."""
    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.models.decoder import decode_splatting

    img, k, timg, tk = inputs
    example = {"context": {"image": img[0], "intrinsics": k[0]},
               "target": {"image": timg[0], "intrinsics": tk[0],
                          "near": np.ones(1, np.float32),
                          "far": np.full(1, 100.0, np.float32)}}
    tenc = torch_v1(v1_params, estimating_focal=True)
    rendered = {}
    for use in (False, True):
        for per_target in (False, True):
            res = evaluate_example(
                tenc, example, HW, eval_cfg=EvalConfig(
                    use_estimated_focal=use, per_target_encoding=per_target),
                device="cpu")
            rendered[use, per_target] = res["rendered"]
    with torch.no_grad():
        out = tenc(*map(to_torch, inputs))
        for use, intr in ((False, to_torch(tk)),
                          (True, out["intrinsics_cwt"][:, 2:])):
            want = decode_splatting(out["gaussians"], out["extrinsics_cwt"][:, 2:],
                                    intr, torch.ones(1, 1),
                                    torch.full((1, 1), 100.0), HW).color[0]
            for per_target in (False, True):
                torch.testing.assert_close(rendered[use, per_target], want)
    assert not torch.allclose(rendered[True, True], rendered[False, True])
