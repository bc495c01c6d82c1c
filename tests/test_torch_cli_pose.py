"""`python -m spfsplatv2_tpu_torch.main mode=eval_pose` vs the JAX CLI.

The same tiny float32 weights (JAX's orbax checkpoint, the port's own)
score feed-forward and PnP poses over the same synthetic test split;
both PnP paths run the native solver of `native/pnp.cc` (the port builds
its own copy under `build/native/`).  Where the solver finds no pose the
JAX package falls back to OpenCV and the port, whose only backend is the
native one, keeps the identity; the JAX run is held to its native path by
making `cv2` unimportable for it.
"""

import json
import sys
from pathlib import Path

import numpy as np

from spfsplatv2_tpu import main as jmain
from spfsplatv2_tpu.config import load_config as j_load_config
from spfsplatv2_tpu.models import get_encoder as j_get_encoder
from spfsplatv2_tpu_torch import main as tmain
from spfsplatv2_tpu_torch.utils import pnp

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    cli_checkpoints,
    cli_overrides,
    cli_test_split,
    random_flax_params,
)

PRESET = str(Path(__file__).resolve().parents[1]
             / "experiments/spfsplatv2/re10k.yaml")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def test_mode_eval_pose_matches_jax(tmp_path, monkeypatch):
    root = cli_test_split(tmp_path / "data")
    jenc = j_get_encoder(j_load_config([PRESET], cli_overrides(
        root, tmp_path)).encoder)
    img = np.zeros((1, 2, 32, 32, 3), np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3))
    params = random_flax_params(jenc, 5, img, k, img[:, :1], k[:, :1])
    jckpt, tckpt = cli_checkpoints(params, tmp_path)

    monkeypatch.setitem(sys.modules, "cv2", None)
    summaries = {}
    for name, main, ckpt, argv in (
            ("jax", jmain.main, jckpt, []),
            ("torch", tmain.main, tckpt, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(argv + ["--config", PRESET] + cli_overrides(
            root, out, ["mode=eval_pose", f"checkpointing.load={ckpt}"])) == 0
        summaries[name] = json.loads((out / "pose_eval.json").read_text())
    assert pnp.native_library().path.parent == pnp.BUILD_DIR
    jsum, tsum = summaries["jax"], summaries["torch"]
    assert set(tsum) == set(jsum) == {"feed_forward", "pnp"}
    jflat, tflat = dict(_leaves(jsum)), dict(_leaves(tsum))
    assert set(tflat) == set(jflat)
    for key, want in jflat.items():
        # Errors in degrees within 1e-3; an AUC moves by at most
        # 1e-3 / threshold with them.
        np.testing.assert_allclose(tflat[key], want, atol=1e-3, err_msg=key)
    assert 0 < tsum["feed_forward"]["rotation_median_deg"] < 180
