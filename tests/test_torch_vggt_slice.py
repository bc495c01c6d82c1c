"""The VGGT-1B family (`spfsplatv2l`) through the port's serving slice,
train step and command line vs the JAX package on the CPU.

The tiny VGGT encoder of tests/test_torch_vggt.py (float32 compute) at
28x28, 2 context views + 1 target, with the same numpy weights on both
sides: JAX's `evaluate_example` and `compute_losses` with its dense
oracle rasterizer (and, for the gradients, its Pallas kernels in
interpret mode), the port's with the kernels' plain versions on CPU
tensors; both CLIs' mode=test from experiments/spfsplatv2-l/re10k.yaml
with overrides only.  The tolerances are those of test_torch_slice.py,
test_torch_train.py and test_torch_cli_test.py.

The random weights put the VGGT points (world points, not pixel rays)
near z = 6.4, clear of the near plane at 1: a Gaussian crossing it is
culled, and near it JAX's own gradients jump under the smallest change
of the weights.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu import main as jmain
from spfsplatv2_tpu.config import load_config as j_load_config
from spfsplatv2_tpu.evaluation import evaluator as jeval
from spfsplatv2_tpu.losses import lpips as jlpips
from spfsplatv2_tpu.models import get_encoder as j_get_encoder
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu.training import step as jstep
from spfsplatv2_tpu_torch import main as tmain
from spfsplatv2_tpu_torch.evaluation import evaluator
from spfsplatv2_tpu_torch.losses import lpips
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LEncoder
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig
from spfsplatv2_tpu_torch.training import optim, step
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_slice import make_example  # noqa: E402
from test_torch_train import make_batch, torch_batch  # noqa: E402
from torch_port_common import (  # noqa: E402
    CLI_INDEX,
    assert_images_close,
    cli_checkpoints,
    cli_test_split,
    jax_tiny_vggt,
    lpips_weights_file,
    random_flax_params,
    torch_tiny_vggt,
    vggt_cli_overrides,
)

HW = (28, 28)
GLOBAL_STEP = 1000
RASTER = dict(entry_budget_factor=4.0, chunk=64)
PRESET = str(Path(__file__).resolve().parents[1]
             / "experiments/spfsplatv2-l/re10k.yaml")


@pytest.fixture(scope="module")
def lpips_pair():
    lp = jax.jit(jlpips.LPIPS().init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3)),
                                      jnp.zeros((1, 64, 64, 3)))
    tlp = lpips.LPIPS()
    tlp.load_state_dict(flax_to_state_dict(lp), strict=True)
    return lp, tlp.eval().requires_grad_(False)


# The render against JAX's dense oracle, which the port's plain K1
# matches; JAX's Pallas K1 (interpret mode) puts a pixel of this 28x28
# scene beyond the 3e-5 bar (its exponent arithmetic; see
# test_torch_train.py on the 1/255 cut-off), one more than 0.1% allows.
@pytest.mark.parametrize("per_target", [True, False])
def test_evaluate_example_matches_jax(lpips_pair, per_target, tmp_path):
    example = make_example(3, HW)
    c, t = example["context"], example["target"]
    jenc = jax_tiny_vggt()
    params = random_flax_params(jenc, 4, c["image"][None], c["intrinsics"][None],
                                t["image"][None], t["intrinsics"][None])
    jlp, tlp = lpips_pair
    jres = jeval.evaluate_example(
        jenc, params, example, HW,
        JDecoderConfig(rasterizer=JRasterizerConfig(backend="reference",
                                                    **RASTER)),
        jeval.EvalConfig(per_target_encoding=per_target, save_images=True,
                         output_path=str(tmp_path)),
        lpips_params=jlp, lpips_calibrated=False,
    )
    cuda_lib.reset_launch_counts()
    tres = evaluator.evaluate_example(
        torch_tiny_vggt(params), example, HW,
        DecoderConfig(rasterizer=RasterizerConfig(**RASTER)),
        evaluator.EvalConfig(per_target_encoding=per_target),
        lpips_params=tlp, lpips_calibrated=False, device="cpu",
    )
    assert not any(cuda_lib.launches().values())
    assert tres["dropped_entries"] == [0]
    rendered = torch.clamp(tres["rendered"], 0, 1).numpy()
    assert_images_close(rendered, jres["images"], atol=3e-5)
    np.testing.assert_allclose(tres["psnr"], jres["psnr"], atol=1e-3)
    np.testing.assert_allclose(tres["ssim"], jres["ssim"], atol=1e-4)
    np.testing.assert_allclose(tres["lpips_uncalibrated"],
                               jres["lpips_uncalibrated"], rtol=1e-4)
    for key in ("pose_rot_err_deg", "pose_transl_err_deg",
                "context_pose_rot_err_deg"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-3, err_msg=key)
    # Context view 0 is the pivot: its translation direction is noise.
    key = "context_pose_transl_err_deg"
    np.testing.assert_allclose(tres[key][1:], jres[key][1:], atol=1e-3)
    # The scene is non-trivial: a real render and real pose errors.
    assert float(np.mean(rendered)) > 0.01 and tres["pose_rot_err_deg"][0] > 1.0


@pytest.fixture(scope="module")
def train_setup(lpips_pair):
    batch = make_batch(5, hw=HW)
    c, t = batch["context"], batch["target"]
    jenc = jax_tiny_vggt()
    params = random_flax_params(jenc, 6, c["image"], c["intrinsics"],
                                t["image"], t["intrinsics"])
    return batch, jenc, params


def _jax_grads(train_setup, lp, backend):
    batch, jenc, params = train_setup
    dcfg = JDecoderConfig(rasterizer=JRasterizerConfig(backend=backend, **RASTER))

    def loss_fn(p):
        return jstep.compute_losses(jenc, p, batch, GLOBAL_STEP, HW, dcfg,
                                    jstep.LossConfig(), lp)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


@pytest.fixture(scope="module")
def port_grads(train_setup, lpips_pair):
    """One port train step's gradients and metrics (max_grad_skip 0 makes
    the step skip, so the gradients stay as the backward left them)."""
    batch, _, params = train_setup
    enc = torch_tiny_vggt(params)
    named = list(enc.named_parameters())
    opt = optim.Optimizer(optim.OptimizerConfig(max_grad_skip=0.0), named)
    train = step.make_train_step(
        enc, opt, HW, DecoderConfig(rasterizer=RasterizerConfig(**RASTER)),
        step.LossConfig(), lpips_pair[1])
    state = step.init_train_state(enc, opt)
    state.step = GLOBAL_STEP
    cuda_lib.reset_launch_counts()
    _, metrics = train(state, torch_batch(batch))
    assert not any(cuda_lib.launches().values())
    assert opt.skipped_count == 1
    return {k: p.grad for k, p in named}, metrics


# The port's plain K1/K2 against JAX's Pallas kernels (2e-3 x max) and
# against JAX's dense oracle (1e-4 x max), as in test_torch_train.py.
@pytest.mark.parametrize("backend,tol", [("pallas", 2e-3), ("reference", 1e-4)])
def test_train_step_losses_and_grads_match_jax(train_setup, lpips_pair,
                                               port_grads, backend, tol):
    (_, jmetrics), jgrads = _jax_grads(train_setup, lpips_pair[0], backend)
    tgrads, tmetrics = port_grads
    assert set(jmetrics) | {"grad/max", "grad/skipped_steps"} == set(tmetrics)
    for key, ref in jmetrics.items():
        np.testing.assert_allclose(tmetrics[key], float(ref), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    assert tmetrics["loss/lpips"] > 0 and tmetrics["raster/dropped_entries"] == 0
    jflat = flax_to_state_dict(jgrads)
    assert set(jflat) == set(tgrads)
    for name, ref in jflat.items():
        got = tgrads[name]
        assert got is not None and torch.isfinite(got).all(), name
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=tol * scale + 1e-12, err_msg=name)
    # Every part of the model learns: DINOv2, the aggregator, both heads
    # and the camera head.
    for part in ("aggregator.patch_embed.blocks.0", "aggregator.global_blocks.1",
                 "point_head", "gaussian_param_head", "camera_head.trunk"):
        assert max(float(g.abs().max()) for n, g in tgrads.items()
                   if n.startswith(part)) > 0, part
    # The optimizer's groups: the camera head and the intrinsics token are
    # new, the aggregator pretrained.
    assert optim.param_label("camera_head.trunk.0.attn.qkv.weight") == "new"
    assert optim.param_label("aggregator.intrinsic_encoder.weight") == "new"
    assert optim.param_label("aggregator.frame_blocks.0.ls1.gamma") == "pretrained"


def test_mode_test_matches_jax(tmp_path):
    """Both CLIs, mode=test, on the same tiny VGGT weights over the same
    synthetic split (32x32 frames cropped to 28x28)."""
    root = cli_test_split(tmp_path / "data")
    lp = lpips_weights_file(tmp_path / "lpips.pt")
    extra = ["mode=test", f"loss.lpips_weights_path={lp}"]
    jcfg = j_load_config([PRESET], vggt_cli_overrides(root, tmp_path, extra))
    jenc = j_get_encoder(jcfg.encoder)
    img = np.zeros((1, 2, *HW, 3), np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3))
    params = random_flax_params(jenc, 7, img, k, img[:, :1], k[:, :1])
    jckpt, tckpt = cli_checkpoints(params, tmp_path)

    encoders = []
    real_load = tmain._load_encoder

    def load_encoder(cfg, device):
        encoders.append(real_load(cfg, device))
        return encoders[-1]

    outs = {}
    tmain._load_encoder = load_encoder
    try:
        for name, main, ckpt, argv in (
                ("jax", jmain.main, jckpt, []),
                ("torch", tmain.main, tckpt, ["--device", "cpu"])):
            out = tmp_path / name
            cuda_lib.reset_launch_counts()
            assert main(argv + ["--config", PRESET] + vggt_cli_overrides(
                root, out, extra + [f"checkpointing.load={ckpt}"])) == 0
            outs[name] = out
    finally:
        tmain._load_encoder = real_load
    assert not any(cuda_lib.launches().values())
    assert [type(e) for e in encoders] == [SPFSplatV2LEncoder]

    jscores, tscores = (json.loads((outs[n] / "scores_all.json").read_text())
                        for n in ("jax", "torch"))
    assert [s["scene"] for s in tscores] == sorted(CLI_INDEX)
    for js, ts in zip(jscores, tscores):
        assert ts["overlap_tag"] == js["overlap_tag"]
        np.testing.assert_allclose(ts["psnr"], js["psnr"], atol=1e-3)
        np.testing.assert_allclose(ts["ssim"], js["ssim"], atol=1e-4)
        np.testing.assert_allclose(ts["lpips"], js["lpips"], rtol=1e-4)
        for key in ("pose_rot_err_deg", "pose_transl_err_deg",
                    "context_pose_rot_err_deg"):
            np.testing.assert_allclose(ts[key], js[key], atol=1e-3,
                                       err_msg=key)
    javg, tavg = (json.loads((outs[n] / "scores_all_avg.json").read_text())
                  for n in ("jax", "torch"))
    assert set(tavg) == set(javg) and tavg["num_scenes"] == 2
    np.testing.assert_allclose(tavg["psnr"], javg["psnr"], atol=1e-3)
