"""`python -m spfsplatv2_tpu_torch.main mode=train` vs the JAX package's CLI.

Both CLIs resume from the same step-0 state (JAX from an orbax `step_0`
of its TrainState, the port from that state converted by
`utils/from_flax.py:checkpoint_from_flax`) and take 2 steps of the
re10k preset's recipe on the same synthetic chunks, tiny float32 encoder
at 32x32, LPIPS off and the dense reference rasterizer: the JAX CPU
compile of its tiled rasterizer's and LPIPS's backward takes most of a
minute, and both are held against JAX elsewhere (test_torch_train.py,
test_torch_backward.py; the port's reading of an LPIPS weights file in
test_torch_cli_test.py).
The data path is held exact in test_torch_data.py; the logged losses
are compared here.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spfsplatv2_tpu import main as jmain
from spfsplatv2_tpu.config import load_config as j_load_config
from spfsplatv2_tpu.models import get_encoder as j_get_encoder
from spfsplatv2_tpu.training import loop as jloop
from spfsplatv2_tpu.training.optim import make_optimizer
from spfsplatv2_tpu.training.step import init_train_state
from spfsplatv2_tpu_torch import main as tmain
from spfsplatv2_tpu_torch.data.synthetic import write_synthetic_dataset
from spfsplatv2_tpu_torch.training import loop as tloop
from spfsplatv2_tpu_torch.utils.from_flax import checkpoint_from_flax

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    cli_overrides,
    random_flax_params,
)

PRESET = str(Path(__file__).resolve().parents[1]
             / "experiments/spfsplatv2/re10k.yaml")
STEPS = 2
# The logged metrics that must agree.  Step 0 runs the same weights on
# the same batch; step 1 runs weights one AdamW update apart, whose
# element-wise first step (lr * sign of the gradient at the warm-up's
# 5e-8) keeps the losses equally close.
RTOL = {0: 1e-4, 1: 1e-4}
KEYS = ("loss/total", "loss/mse", "loss/reproj_c1",
        "loss/reproj_c2", "train/psnr", "pose/context_rot_deg")


def _capture(module, logged, monkeypatch):
    """Wrap `module.run_training` to record every logged step at full
    precision (the CLI prints 5 digits)."""
    real = module.run_training

    def run(cfg, log_fn=None, **kwargs):
        def log(step, metrics):
            logged.setdefault(step, {}).update(metrics)
            log_fn(step, metrics)

        return real(cfg, log_fn=log, **kwargs)

    monkeypatch.setattr(module, "run_training", run)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    # The preset's curriculum starts at a 25-frame gap.
    write_synthetic_dataset(root, 2, 30, (32, 32), "train")
    return root


def test_mode_train_resumes_and_matches_jax(train_root, tmp_path, monkeypatch):
    # b = 8: the JAX package shards the batch over the 8 CPU devices of
    # the test mesh (conftest.py).
    extra = ["mode=train", f"trainer.max_steps={STEPS}", "trainer.batch_size=8",
             "trainer.val_check_interval=0", "train.print_log_every_n_steps=1",
             "checkpointing.every_n_train_steps=0", "checkpointing.resume=true",
             "loss.use_lpips=false", "decoder.rasterizer.backend=reference",
             # Remat changes what the backward keeps, not the numbers; off,
             # JAX's eager init and its compile take half the time.
             "encoder.spfsplatv2.backbone.remat=false",
             "encoder.spfsplatv2.remat_heads=false"]
    ov = {n: cli_overrides(train_root, tmp_path / n, extra)
          for n in ("jax", "torch")}
    cfg = j_load_config([PRESET], ov["jax"])
    jenc = j_get_encoder(cfg.encoder)
    img = np.zeros((1, 2, 32, 32, 3), np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3))
    params = random_flax_params(jenc, 7, img, k, img[:, :1], k[:, :1])
    state = init_train_state(jenc, make_optimizer(cfg.optimizer, params),
                             params)
    jloop.save_checkpoint(tmp_path / "jax" / "checkpoints", state, 0)
    zeros = jax.tree.map(np.zeros_like, params)
    torch.save(checkpoint_from_flax(params, zeros, zeros, count=0, step=0),
               _port_step0(tmp_path / "torch"))

    # The resume replaces JAX's seeded init, which runs eagerly and costs
    # most of a minute of small compiles on the CPU: hand it the params.
    monkeypatch.setattr(type(jenc), "init", lambda self, *args: params)
    logged = {"jax": {}, "torch": {}}
    _capture(jloop, logged["jax"], monkeypatch)
    _capture(tloop, logged["torch"], monkeypatch)
    assert jmain.main(["--config", PRESET] + ov["jax"]) == 0
    assert tmain.main(["--device", "cpu", "--config", PRESET]
                      + ov["torch"]) == 0

    assert sorted(logged["torch"]) == sorted(logged["jax"]) == [0, 1]
    for step in range(STEPS):
        jm, tm = logged["jax"][step], logged["torch"][step]
        # JAX also logs its compiled step's memory estimate, off the card too.
        assert set(jm) - {"mem/peak_hbm_gb"} | {"time/data_wait_ms"} == set(tm)
        for key in KEYS:
            np.testing.assert_allclose(tm[key], jm[key], rtol=RTOL[step],
                                       err_msg=f"step {step} {key}")
        assert tm["grad/skipped_steps"] == jm["grad/skipped_steps"] == 0
        assert tm["time/data_wait_ms"] >= 0
    # The final checkpoint holds the 2 applied updates.
    final = tloop.load_checkpoint(tmp_path / "torch" / "checkpoints" / "step_-1")
    assert (final["step"], final["count"], final["skipped_count"]) == (2, 2, 0)
    assert set(final["mu"]) == set(final["encoder"])


def _port_step0(out_dir):
    path = out_dir / "checkpoints" / "step_0"
    path.mkdir(parents=True)
    return path / tloop.CHECKPOINT_FILE
