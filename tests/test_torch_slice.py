"""The port's serving slice end to end vs the JAX package on the CPU.

One synthetic scene (2 context views + 1 target at 32x32, random GT
poses) goes through the JAX `evaluate_example` (Pallas backend in
interpret mode) and the port's `evaluate_example` (plain kernel versions
on CPU tensors), with the same numpy weights.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spfsplatv2_tpu.evaluation import evaluator as jeval
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu_torch.evaluation import evaluator
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    assert_images_close,
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


def make_example(seed=0):
    rng = np.random.default_rng(seed)
    k = np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    view = lambda n: {
        "image": f32(rng.uniform(0, 1, (n, *HW, 3))),
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


@pytest.mark.parametrize("per_target", [True, False])
def test_evaluate_example_matches_jax(setup, per_target, tmp_path):
    example, jenc, params, tenc = setup
    jres = jeval.evaluate_example(
        jenc, params, example, HW,
        JDecoderConfig(rasterizer=JRasterizerConfig(
            backend="pallas", entry_budget_factor=4.0, chunk=64)),
        jeval.EvalConfig(per_target_encoding=per_target, save_images=True,
                         output_path=str(tmp_path)),
    )
    cuda_lib.reset_launch_counts()
    tres = evaluator.evaluate_example(
        tenc, example, HW,
        DecoderConfig(rasterizer=RasterizerConfig(entry_budget_factor=4.0,
                                                  chunk=64)),
        evaluator.EvalConfig(per_target_encoding=per_target),
        device="cpu",
    )
    # CPU tensors take the plain kernel versions: no launch.
    assert cuda_lib.launch_counts == {"composite_forward": 0, "cumsum_1d": 0}
    assert tres["dropped_entries"] == [0]
    assert tres["overlap_tag"] == jres["overlap_tag"] == "medium"
    rendered = torch.clamp(tres["rendered"], 0, 1).numpy()
    assert_images_close(rendered, jres["images"], atol=3e-5)
    np.testing.assert_allclose(tres["psnr"], jres["psnr"], atol=1e-3)
    np.testing.assert_allclose(tres["ssim"], jres["ssim"], atol=1e-4)
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


def test_align_pose_raises(setup):
    example, _, _, tenc = setup
    with pytest.raises(NotImplementedError, match="K2"):
        evaluator.evaluate_example(tenc, example, HW,
                                   eval_cfg=evaluator.EvalConfig(align_pose=True),
                                   device="cpu")
