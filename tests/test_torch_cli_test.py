"""`python -m spfsplatv2_tpu_torch.main mode=test` vs the JAX package's CLI.

Both CLIs evaluate the same tiny float32 encoder weights (JAX from an
orbax checkpoint, the port from its own) over the same synthetic test
split and evaluation index, with the same LPIPS weights file, from
`experiments/spfsplatv2/re10k.yaml` with overrides only.  JAX renders
through its CPU rasterizer, the port through the kernels' plain versions.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from spfsplatv2_tpu import main as jmain
from spfsplatv2_tpu.config import load_config as j_load_config
from spfsplatv2_tpu.models import get_encoder as j_get_encoder
from spfsplatv2_tpu_torch import main as tmain
from spfsplatv2_tpu_torch.ops import cuda_lib

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CLI_INDEX,
    cli_checkpoints,
    cli_overrides,
    cli_test_split,
    lpips_weights_file,
    random_flax_params,
)

PRESET = str(Path(__file__).resolve().parents[1]
             / "experiments/spfsplatv2/re10k.yaml")
ARTIFACTS = {"scores_all.json", "scores_all_avg.json", "scores_sub_avg.json",
             "benchmark.json", "peak_memory.json",
             "scene_000/color/000003.png", "scene_000/color/000004.png",
             "scene_001/color/000005.png"}


def test_mode_test_matches_jax(tmp_path):
    from PIL import Image

    root = cli_test_split(tmp_path / "data")
    lp = lpips_weights_file(tmp_path / "lpips.pt")
    extra = ["mode=test", "test.save_image=true",
             f"loss.lpips_weights_path={lp}"]
    jenc = j_get_encoder(j_load_config([PRESET], cli_overrides(
        root, tmp_path, extra)).encoder)
    img = np.zeros((1, 2, 32, 32, 3), np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3))
    params = random_flax_params(jenc, 3, img, k, img[:, :1], k[:, :1])
    jckpt, tckpt = cli_checkpoints(params, tmp_path)

    outs = {}
    for name, main, ckpt, argv in (
            ("jax", jmain.main, jckpt, []),
            ("torch", tmain.main, tckpt, ["--device", "cpu"])):
        out = tmp_path / name
        cuda_lib.reset_launch_counts()
        assert main(argv + ["--config", PRESET] + cli_overrides(
            root, out, extra + [f"checkpointing.load={ckpt}"])) == 0
        outs[name] = out
    assert not any(cuda_lib.launches().values())

    for name, out in outs.items():
        files = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}
        assert files == ARTIFACTS, name
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
        # Context view 0 is the pivot: its translation is zero up to
        # rounding, and that direction's angle is rounding noise.
        key = "context_pose_transl_err_deg"
        np.testing.assert_allclose(ts[key][1:], js[key][1:], atol=1e-3)
    javg, tavg = (json.loads((outs[n] / "scores_all_avg.json").read_text())
                  for n in ("jax", "torch"))
    assert set(tavg) == set(javg) and tavg["num_scenes"] == 2
    np.testing.assert_allclose(tavg["psnr"], javg["psnr"], atol=1e-3)
    jsub, tsub = (json.loads((outs[n] / "scores_sub_avg.json").read_text())
                  for n in ("jax", "torch"))
    assert set(tsub) == set(jsub) == {"small", "medium"}
    bench = json.loads((outs["torch"] / "benchmark.json").read_text())
    assert bench["encoder"]["count"] == bench["decoder"]["count"] == 3
    # The saved frames: 8-bit, the renders agree to a level or two.
    for png in sorted(a for a in ARTIFACTS if a.endswith(".png")):
        j, t = (np.asarray(Image.open(outs[n] / png), np.int32)
                for n in ("jax", "torch"))
        assert t.shape == (32, 32, 3) and t.std() > 0
        assert np.abs(t - j).max() <= 2, png


def test_mode_test_needs_a_checkpoint(tmp_path):
    root = cli_test_split(tmp_path / "data")
    with pytest.raises(SystemExit, match="checkpointing.load"):
        tmain.main(["--device", "cpu", "--config", PRESET, "mode=test"]
                   + cli_overrides(root, tmp_path))
