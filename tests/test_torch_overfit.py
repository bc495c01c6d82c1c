"""`python -m spfsplatv2_tpu_torch.overfit` vs `scripts/overfit_flagship.py`.

The port's flagship overfit run takes the script's recipe unchanged: its
override list is read from the script with `ast` (the script is not
run) and both packages' `load_config` build the same config from it.
Two steps of the recipe at the tiny widths of `torch_port_common.py`
(32x32, the dense reference rasterizer) run through the port's entry
point and through JAX's `run_training` from the same step-0 state; the
logged losses agree.  The committed artifact of the 3000-step run on the
card is pinned as `tests/test_overfit_artifact.py` pins JAX's.
"""

import ast
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.config import _to_dict as j_to_dict
from spfsplatv2_tpu.config import load_config as j_load_config
from spfsplatv2_tpu.data.synthetic import (
    write_synthetic_dataset as j_write_synthetic_dataset,
)
from spfsplatv2_tpu.models import get_encoder as j_get_encoder
from spfsplatv2_tpu.parallel import make_mesh as j_make_mesh
from spfsplatv2_tpu.training import loop as jloop
from spfsplatv2_tpu_torch import config, overfit
from spfsplatv2_tpu_torch.training import loop as tloop
from spfsplatv2_tpu_torch.utils.from_flax import checkpoint_from_flax

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    TINY_BACKBONE,
    TINY_HEADS,
    random_flax_params,
)

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "overfit_flagship.py"
JAX_ARTIFACT = REPO / "artifacts" / "overfit_flagship.json"
ARTIFACT = REPO / "artifacts" / "overfit_flagship_torch.json"
STEPS = 2
RTOL = 1e-4
KEYS = ("loss/total", "loss/mse", "train/psnr")


def _script_main() -> ast.FunctionDef:
    tree = ast.parse(SCRIPT.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _call(func: ast.FunctionDef, name: str) -> ast.Call:
    return next(n for n in ast.walk(func) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name) and n.func.id == name)


def _template(node) -> str:
    """A list entry of the script as a `str.format` template: its
    f-string fields become `{name}`."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant)
                   else "{" + v.value.id + "}" for v in node.values)


def script_overrides() -> list[str]:
    return [_template(n) for n in _call(_script_main(), "load_config").args[1].elts]


def script_assignment(name: str):
    return next(ast.literal_eval(n.value) for n in ast.walk(_script_main())
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)


def test_recipe_is_the_scripts():
    ours = list(overfit.OVERFIT_OVERRIDES)
    assert ours == script_overrides()
    # The two f-string entries, by their keys.
    fields = {o.split("=", 1)[0]: o for o in ours if "{" in o}
    assert fields == {"dataset.roots": "dataset.roots=[{root}]",
                      "optimizer.max_steps": "optimizer.max_steps={max_steps}"}
    # The defaults: the script's steps and its scene.
    assert overfit.MAX_STEPS == script_assignment("max_steps") == 3000
    scene = _call(_script_main(), "write_synthetic_dataset")
    kw = {k.arg: ast.literal_eval(k.value) for k in scene.keywords}
    assert kw == {"num_scenes": 1, "num_frames": overfit.NUM_FRAMES,
                  "image_hw": overfit.IMAGE_HW}
    assert "dataset.overfit_to_scene=" + overfit.SCENE in ours
    # The entry point formats them, then keeps its output under --root.
    ov = overfit.recipe_overrides("/data/scene", 17, ["x=1"])
    assert ov[0] == "dataset.roots=[/data/scene]"
    assert "optimizer.max_steps=17" in ov
    assert ov[-2:] == ["output_dir=/data/scene/run", "x=1"]


def test_recipe_config_matches_jax():
    root = "/data/overfit"
    ov = overfit.recipe_overrides(root)
    theirs = [t.format(root=root, max_steps=overfit.MAX_STEPS)
              for t in script_overrides()] + [f"output_dir={root}/run"]
    assert ov == theirs
    ours = config.load_config([overfit.PRESET], ov)
    assert config._to_dict(ours) == j_to_dict(j_load_config([overfit.PRESET],
                                                            theirs))
    assert (ours.trainer.batch_size, ours.optimizer.max_grad_skip,
            ours.optimizer.backbone_lr_multiplier, ours.loss.use_lpips,
            ours.output_dir) == (2, 50.0, 1.0, False, f"{root}/run")


def _tiny_overrides():
    ov = [f"encoder.spfsplatv2.backbone.{k}={v}" for k, v in TINY_BACKBONE.items()]
    ov += [f"encoder.spfsplatv2.{k}={list(v) if isinstance(v, tuple) else v}"
           for k, v in TINY_HEADS.items()]
    return ov + ["image_shape=[32,32]", "dataset.input_image_shape=[32,32]",
                 "decoder.rasterizer.backend=reference",
                 "train.print_log_every_n_steps=1",
                 # Remat changes what the backward keeps, not the numbers;
                 # off, JAX's compile takes half the time.
                 "encoder.spfsplatv2.backbone.remat=false",
                 "encoder.spfsplatv2.remat_heads=false"]


def _capture(module, logged, monkeypatch):
    real = module.run_training

    def run(cfg, log_fn=None, **kwargs):
        def log(step, metrics):
            logged[step] = dict(metrics)
            log_fn(step, metrics)

        return real(cfg, log_fn=log, **kwargs)

    monkeypatch.setattr(module, "run_training", run)


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """JAX's scene, written as the script writes it."""
    root = tmp_path_factory.mktemp("jax_scene")
    j_write_synthetic_dataset(root, num_scenes=1, num_frames=30,
                              image_hw=(256, 256))
    return root


def test_two_tiny_steps_match_jax(jax_scene, tmp_path, monkeypatch):
    extra = _tiny_overrides()
    t_root, j_root = tmp_path / "torch", jax_scene
    j_ov = [t.format(root=j_root, max_steps=overfit.MAX_STEPS)
            for t in script_overrides()] + [f"output_dir={tmp_path}/jax", *extra]
    cfg = j_load_config([overfit.PRESET], j_ov)
    jenc = j_get_encoder(cfg.encoder)
    img = np.zeros((1, 2, 32, 32, 3), np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3))
    params = random_flax_params(jenc, 7, img, k, img[:, :1], k[:, :1])
    # The same step-0 state: JAX's run initialises to `params` (its
    # seeded init replaced) and the port's resumes from them.
    zeros = jax.tree.map(np.zeros_like, params)
    port_step0 = t_root / "run" / "checkpoints" / "step_0"
    port_step0.mkdir(parents=True)
    torch.save(checkpoint_from_flax(params, zeros, zeros, count=0, step=0),
               port_step0 / tloop.CHECKPOINT_FILE)

    monkeypatch.setattr(type(jenc), "init", lambda self, *args: params)
    # b = 2 on one device (the test mesh has 8).
    monkeypatch.setattr(jloop, "make_mesh", lambda: j_make_mesh(n_data=1))
    logged = {"jax": {}, "torch": {}}
    _capture(jloop, logged["jax"], monkeypatch)
    _capture(tloop, logged["torch"], monkeypatch)
    jloop.run_training(cfg, max_steps=STEPS, log_fn=lambda s, m: None)
    out = tmp_path / "artifact.json"
    assert overfit.main(["--device", "cpu", "--steps", str(STEPS),
                         "--root", str(t_root), "--out", str(out), *extra]) == 0

    # The entry point wrote the script's scene, byte for byte.
    assert ((t_root / "train" / "000000.torch").read_bytes()
            == (j_root / "train" / "000000.torch").read_bytes())
    assert sorted(logged["torch"]) == sorted(logged["jax"]) == [0, 1]
    for step in range(STEPS):
        for key in KEYS:
            np.testing.assert_allclose(
                logged["torch"][step][key], logged["jax"][step][key],
                rtol=RTOL, err_msg=f"step {step} {key}")
        assert (logged["torch"][step]["grad/skipped_steps"]
                == logged["jax"][step]["grad/skipped_steps"] == 0)

    artifact = json.loads(out.read_text())
    assert set(json.loads(JAX_ARTIFACT.read_text())) <= set(artifact)
    assert artifact["steps"] == STEPS and artifact["device"] == "cpu"
    assert artifact["steps_per_s_steps"] == [0, STEPS - 1]
    assert [e["step"] for e in artifact["curve"]] == [0, 1]
    for entry, metrics in zip(artifact["curve"], (logged["torch"][0],
                                                   logged["torch"][1])):
        assert entry == overfit.curve_entry(entry["step"], metrics)
    assert artifact["best_psnr"] == max(e["psnr"] for e in artifact["curve"])
    assert artifact["final_psnr"] == artifact["curve"][-1]["psnr"]


def test_short_run_resumes_its_curve(jax_scene, tmp_path):
    """A second run on the same --root resumes from the newest checkpoint
    and keeps the earlier segment's curve points."""
    shutil.copytree(jax_scene / "train", tmp_path / "train")
    extra = _tiny_overrides() + ["checkpointing.every_n_train_steps=1"]
    out = tmp_path / "artifact.json"
    argv = ["--device", "cpu", "--root", str(tmp_path), "--out", str(out)]
    assert overfit.main(argv + ["--steps", "2", *extra]) == 0
    # Saved after step 1: the next segment starts at step 2.
    assert overfit.resume_step(tmp_path / "run" / "checkpoints") == 2
    assert overfit.main(argv + ["--steps", "3", *extra]) == 0
    artifact = json.loads(out.read_text())
    assert [e["step"] for e in artifact["curve"]] == [0, 1, 2]
    assert artifact["steps_per_s_steps"] == [2, 2]
    assert artifact["curve"][-1]["skipped"] == 0


# ---- the committed artifact of the 3000-step run on the card ----------

@pytest.fixture(scope="module")
def artifact():
    if not ARTIFACT.exists():
        pytest.fail("artifacts/overfit_flagship_torch.json missing: run "
                    "`python -m spfsplatv2_tpu_torch.overfit` on the card "
                    "and commit the result")
    return json.loads(ARTIFACT.read_text())


def test_artifact_converged_past_25_psnr(artifact):
    assert artifact["best_psnr"] > overfit.BAR_PSNR, artifact["best_psnr"]


def test_artifact_regime_is_stated(artifact):
    assert "from-scratch" in artifact["regime"]
    assert "use_lpips=false" in artifact["regime"]
    assert "fine-tune" in artifact["not_demonstrated"]


def test_artifact_full_flagship_scale(artifact):
    assert artifact["steps"] >= overfit.MAX_STEPS
    assert artifact["params"] == 608_017_854
    assert artifact["scene"].startswith("synthetic scene_000, 256x256, b=2")
    assert artifact["model"] == "SPFSplatV2 flagship (default config)"


def test_artifact_curve_shows_actual_training(artifact):
    curve = artifact["curve"]
    assert len(curve) >= 50
    last = curve[-1]
    assert last["skipped"] < 0.05 * last["step"] + 10
    best = max(c["psnr"] for c in curve)
    assert best == artifact["best_psnr"]
    assert best > curve[0]["psnr"] + 8.0


def test_artifact_names_the_card(artifact):
    # nvidia-smi's "name, power.limit" line, beside the steps a second.
    name, limit = artifact["device"].rsplit(", ", 1)
    assert name.startswith("NVIDIA H100")
    assert limit.endswith(" W") and float(limit[:-2]) > 0
    assert artifact["steps_per_s"] > 0
