"""The port's serving slice end to end vs the JAX package on the CPU.

One synthetic scene (2 context views + 1 target at 32x32, random GT
poses) goes through the JAX `evaluate_example` (Pallas backend in
interpret mode) and the port's `evaluate_example` (plain kernel versions
on CPU tensors), with the same numpy weights.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.evaluation import evaluator as jeval
from spfsplatv2_tpu.losses.lpips import LPIPS as JLPIPS
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu_torch.evaluation import evaluator
from spfsplatv2_tpu_torch.losses.lpips import LPIPS
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    assert_images_close,
    to_torch,
    jax_tiny_encoder,
    random_flax_params,
    torch_tiny_encoder,
)

HW = (32, 32)


def _pose(rng, angle=0.1, shift=0.3):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    k = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    m[:3, 3] = rng.uniform(-shift, shift, 3)
    return m


def make_example(seed=0, hw=HW):
    rng = np.random.default_rng(seed)
    k = np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    view = lambda n: {
        "image": f32(rng.uniform(0, 1, (n, *hw, 3))),
        "intrinsics": f32(np.repeat(k[None], n, 0)),
        "extrinsics": f32(np.stack([_pose(rng) for _ in range(n)])),
        "near": f32(np.full((n,), 1.0)),
        "far": f32(np.full((n,), 100.0)),
    }
    ctx, tgt = view(2), view(1)
    ctx["overlap"] = 0.4
    return {"scene": "synthetic", "context": ctx, "target": tgt}


@pytest.fixture(scope="module")
def setup():
    example = make_example()
    c, t = example["context"], example["target"]
    jenc = jax_tiny_encoder()
    params = random_flax_params(jenc, 2, c["image"][None], c["intrinsics"][None],
                                t["image"][None], t["intrinsics"][None])
    return example, jenc, params, torch_tiny_encoder(params)


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX LPIPS params from its random init and the port's LPIPS holding
    the same weights."""
    lp = jax.jit(JLPIPS().init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 64, 64, 3)))
    tlp = LPIPS()
    tlp.load_state_dict(flax_to_state_dict(lp), strict=True)
    return lp, tlp.eval()


@pytest.mark.parametrize("per_target", [True, False])
def test_evaluate_example_matches_jax(setup, lpips_pair, per_target, tmp_path):
    example, jenc, params, tenc = setup
    jlp, tlp = lpips_pair
    jres = jeval.evaluate_example(
        jenc, params, example, HW,
        JDecoderConfig(rasterizer=JRasterizerConfig(
            backend="pallas", entry_budget_factor=4.0, chunk=64)),
        jeval.EvalConfig(per_target_encoding=per_target, save_images=True,
                         output_path=str(tmp_path)),
        lpips_params=jlp, lpips_calibrated=False,
    )
    cuda_lib.reset_launch_counts()
    tres = evaluator.evaluate_example(
        tenc, example, HW,
        DecoderConfig(rasterizer=RasterizerConfig(entry_budget_factor=4.0,
                                                  chunk=64)),
        evaluator.EvalConfig(per_target_encoding=per_target),
        lpips_params=tlp, lpips_calibrated=False, device="cpu",
    )
    # CPU tensors take the plain kernel versions: no launch.
    assert all(v == 0 for v in cuda_lib.launch_counts.values())
    assert tres["dropped_entries"] == [0]
    assert tres["overlap_tag"] == jres["overlap_tag"] == "medium"
    rendered = torch.clamp(tres["rendered"], 0, 1).numpy()
    assert_images_close(rendered, jres["images"], atol=3e-5)
    np.testing.assert_allclose(tres["psnr"], jres["psnr"], atol=1e-3)
    np.testing.assert_allclose(tres["ssim"], jres["ssim"], atol=1e-4)
    assert "lpips" not in tres
    np.testing.assert_allclose(tres["lpips_uncalibrated"],
                               jres["lpips_uncalibrated"], rtol=1e-4)
    assert tres["lpips_uncalibrated"][0] > 0.0
    for key in ("pose_rot_err_deg", "pose_transl_err_deg",
                "context_pose_rot_err_deg"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-3, err_msg=key)
    # Context view 0 is the pivot: its predicted translation is zero up to
    # rounding, so its direction (and that angle) is rounding noise.
    key = "context_pose_transl_err_deg"
    np.testing.assert_allclose(tres[key][1:], jres[key][1:], atol=1e-3)
    # The scene is non-trivial: a real render and real pose errors.
    assert 0.0 < float(np.mean(rendered)) and tres["pose_rot_err_deg"][0] > 1.0


def test_entry_point_defaults_to_cuda(setup):
    """No silent CPU fallback: without a card the default device fails."""
    example, _, _, tenc = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        evaluator.evaluate_example(tenc, example, HW)


def test_align_poses_matches_jax(setup):
    """5 Adam steps of test-time pose alignment through the renderer (K2's
    plain version) on the JAX encoder's Gaussians, from a perturbed pose."""
    import jax

    from spfsplatv2_tpu.evaluation.pose_align import align_poses as jalign
    from spfsplatv2_tpu.gaussians import Gaussians as JGaussians
    from spfsplatv2_tpu_torch.evaluation.pose_align import align_poses
    from spfsplatv2_tpu_torch.gaussians import Gaussians

    example, jenc, params, _ = setup
    c, t = example["context"], example["target"]
    out = jax.jit(jenc.apply)(params, c["image"][None], c["intrinsics"][None])
    fields = {k: np.asarray(v) for k, v in vars(out["gaussians"]).items()}
    init = np.asarray(out["extrinsics_cwt"])[:, 1:2] @ _pose(
        np.random.default_rng(1), angle=0.02, shift=0.02).astype(np.float32)
    args = (t["intrinsics"][None], t["near"][None], t["far"][None],
            t["image"][None], HW)
    kw = dict(steps=5, lr=5e-4)
    jext, jloss = jalign(JGaussians(**fields), init, *args, **kw,
                         decoder_cfg=JDecoderConfig(rasterizer=JRasterizerConfig(
                             backend="pallas", entry_budget_factor=4.0, chunk=64)))
    text, tloss = align_poses(
        Gaussians(**{k: to_torch(v) for k, v in fields.items()}), to_torch(init),
        *[to_torch(a) for a in args[:4]], HW, **kw,
        decoder_cfg=DecoderConfig(rasterizer=RasterizerConfig(
            entry_budget_factor=4.0, chunk=64)))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(text.numpy(), np.asarray(jext), atol=1e-4)
    # The pose moved: 5 steps at lr 5e-4 shift it by ~1e-3.
    assert np.abs(text.numpy() - init).max() > 5e-4


def test_evaluate_example_aligns_poses(setup):
    example, _, _, tenc = setup
    base = evaluator.evaluate_example(tenc, example, HW, device="cpu")
    bench = evaluator.Benchmarker("cpu")
    res = evaluator.evaluate_example(
        tenc, example, HW, eval_cfg=evaluator.EvalConfig(
            align_pose=True, pose_align_steps=3), benchmarker=bench,
        device="cpu")
    assert bench.summarize()["pose_optimize"]["count"] == 1
    assert res["pose_rot_err_deg"] != base["pose_rot_err_deg"]
    assert np.isfinite(res["psnr"]).all()
