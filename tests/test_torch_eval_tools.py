"""The port's offline evaluation tools and video outputs of test and
validation vs the JAX package on the CPU: `compute_metrics_for_methods`
over seeded PNG directories, `generate_index` over seeded pose tracks,
`evaluate_example(save_video=True)` and `run_validation_step`'s videos.

JAX's validation step applies the encoder eagerly, op by op (tens of
seconds on the CPU); the test hands it the same module with `apply`
jitted (`jitted`), and JAX's video renders one camera a call
(`per_camera`); both in torch_port_common.py.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spfsplatv2_tpu.evaluation import evaluator as jevaluator
from spfsplatv2_tpu.evaluation import index_generator as jindex
from spfsplatv2_tpu.evaluation import metric_computer as jmetric
from spfsplatv2_tpu.evaluation import video as jvideo
from spfsplatv2_tpu.losses.lpips import get_lpips_params
from spfsplatv2_tpu.training import validation as jvalidation
from spfsplatv2_tpu_torch.evaluation import evaluator, index_generator
from spfsplatv2_tpu_torch.evaluation import metric_computer
from spfsplatv2_tpu_torch.losses.lpips import get_lpips
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.training import validation

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_slice import _pose  # noqa: E402
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    jax_tiny_encoder,
    jitted,
    lpips_weights_file,
    per_camera,
    random_flax_params,
    torch_tiny_encoder,
)

HW = (32, 32)


# ---- compute_metrics_for_methods ------------------------------------------

def write_dumps(root):
    """<root>/{gt,ours,blurry}/<scene>/<frame>.png, seeded; "blurry" lacks
    one frame (skipped, as in JAX), and a stray file sits in gt/."""
    rng = np.random.default_rng(8)
    for scene in ("scene_a", "scene_b"):
        for frame in range(2):
            gt = rng.uniform(0, 1, (40, 48, 3))
            noisy = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1)
            blurry = (gt + np.roll(gt, 1, 0) + np.roll(gt, 1, 1)) / 3
            for method, img in (("gt", gt), ("ours", noisy), ("blurry", blurry)):
                if method == "blurry" and (scene, frame) == ("scene_b", 1):
                    continue
                path = root / method / scene / f"{frame:06}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray((img * 255).astype(np.uint8)).save(path)
    (root / "gt" / "notes.txt").write_text("not a scene")


def test_metric_computer_matches_jax(tmp_path):
    weights = lpips_weights_file(tmp_path / "lpips.pt")
    jlpips, _ = get_lpips_params(True, str(weights))
    tlpips, calibrated = get_lpips(True, str(weights), device="cpu")
    assert calibrated
    for name in ("jax", "torch"):
        write_dumps(tmp_path / name)
    ref = jmetric.compute_metrics_for_methods(
        tmp_path / "jax", ["ours", "blurry"], lpips_params=jlpips,
        save_comparison=True)
    ours = metric_computer.compute_metrics_for_methods(
        tmp_path / "torch", ["ours", "blurry"], lpips=tlpips,
        save_comparison=True, device="cpu")
    assert ours.keys() == ref.keys() == {"ours", "blurry"}
    for method in ours:
        assert ours[method]["num_images"] == ref[method]["num_images"]
        for key in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(ours[method][key], ref[method][key],
                                       rtol=1e-4, err_msg=f"{method} {key}")
    assert ours["ours"]["num_images"] == 4 and ours["blurry"]["num_images"] == 3
    assert json.loads((tmp_path / "torch/metric_computer.json").read_text()) \
        == ours
    sheets = sorted(p.relative_to(tmp_path / "torch")
                    for p in (tmp_path / "torch/comparisons").rglob("*.png"))
    assert len(sheets) == 7
    for rel in sheets:
        a = np.asarray(Image.open(tmp_path / "torch" / rel))
        b = np.asarray(Image.open(tmp_path / "jax" / rel))
        assert a.shape == (40, 100, 3)
        np.testing.assert_array_equal(a, b)


# ---- generate_index -------------------------------------------------------

def pose_track(seed, n):
    """A camera drifting sideways and turning, as (n, 18) chunk rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        yaw = 0.006 * i + 0.002 * rng.standard_normal()
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]]
        c2w[:3, 3] = [0.01 * i, 0.002 * rng.standard_normal(), 0.0]
        w2c = np.linalg.inv(c2w)
        rows.append(np.concatenate([[1.0, 1.2, 0.5, 0.5, 0, 0],
                                    w2c[:3].reshape(-1)]))
    return np.asarray(rows, np.float32)


def test_generate_index_matches_jax(tmp_path):
    dataset = [{"key": f"scene_{i}", "cameras": pose_track(i, n)}
               for i, n in enumerate((160, 150, 20))]
    cfgs = [cls(num_target_views=2, min_distance=20, max_distance=120,
                output_path=str(tmp_path / name / "index.json"), seed=3)
            for cls, name in ((jindex.IndexGeneratorConfig, "jax"),
                              (index_generator.IndexGeneratorConfig, "torch"))]
    ref = jindex.generate_index(dataset, cfgs[0])
    ours = index_generator.generate_index(dataset, cfgs[1], device="cpu")
    assert ours.keys() == ref.keys()
    for key in ref:
        if ref[key] is None:
            assert ours[key] is None, key
            continue
        assert ours[key]["context"] == ref[key]["context"], key
        assert ours[key]["target"] == ref[key]["target"], key
        np.testing.assert_allclose(ours[key]["overlap"], ref[key]["overlap"],
                                   atol=1e-6)
    # Two scenes find a pair inside [0.4, 0.8]; the short one cannot.
    assert ours["scene_2"] is None
    assert all(0.4 <= ours[k]["overlap"] <= 0.8 for k in ("scene_0", "scene_1"))
    assert json.loads(Path(cfgs[1].output_path).read_text()) == ours


# ---- video outputs of test and validation ---------------------------------

def make_example(seed=0, n_tgt=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:HW[0], :HW[1]] / HW[0]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def view(n):
        base = np.stack([xx, yy, 0.5 + 0.3 * np.sin(7 * xx)], -1)
        return {"image": f32(np.clip(base + 0.1 * rng.standard_normal(
                    (n, *HW, 3)), 0, 1)),
                "intrinsics": f32(np.tile(CAMERA_K, (n, 1, 1))),
                "extrinsics": f32(np.stack([_pose(rng) for _ in range(n)])),
                "near": f32(np.full((n,), 1.0)),
                "far": f32(np.full((n,), 100.0))}

    ctx, tgt = view(2), view(n_tgt)
    ctx["index"], tgt["index"] = [3, 17], [8, 12][:n_tgt]
    return {"scene": "synthetic", "context": ctx, "target": tgt}


@pytest.fixture(scope="module")
def setup():
    example = make_example()
    c, t = example["context"], example["target"]
    jenc = jax_tiny_encoder()
    params = random_flax_params(jenc, 4, c["image"][None], c["intrinsics"][None],
                                t["image"][None, :1], t["intrinsics"][None, :1])
    return example, jenc, params, torch_tiny_encoder(params)



def test_evaluate_example_saves_video_as_jax(setup, tmp_path):
    example, jenc, params, tenc = setup
    jevaluator.evaluate_example(
        jenc, params, example, HW,
        eval_cfg=jevaluator.EvalConfig(save_video=True,
                                       output_path=str(tmp_path / "jax")))
    res = evaluator.evaluate_example(
        tenc, example, HW,
        eval_cfg=evaluator.EvalConfig(save_video=True,
                                      output_path=str(tmp_path / "torch")),
        device="cpu")
    assert res["images"] is None
    names = {p.name for p in (tmp_path / "jax" / "video").iterdir()}
    assert names == {p.name for p in (tmp_path / "torch" / "video").iterdir()}
    assert names == {"synthetic_frame_3_17.gif"}
    paths = [tmp_path / d / "video" / "synthetic_frame_3_17.gif"
             for d in ("torch", "jax")]
    ours_gif, ref_gif = (Image.open(p) for p in paths)
    assert ours_gif.n_frames == ref_gif.n_frames == 2
    assert ours_gif.size == ref_gif.size == HW[::-1]
    # The first frame is the rendered target, as written.
    want = np.clip(res["rendered"][0].numpy() * 255, 0, 255).astype(np.uint8)
    got = np.asarray(ours_gif.convert("RGB"))
    assert np.abs(got.astype(int) - want).mean() < 8


def test_run_validation_step_writes_videos_as_jax(setup, tmp_path, monkeypatch,
                                                  capsys):
    example, jenc, params, tenc = setup
    monkeypatch.setattr(jvideo, "decode_splatting",
                        per_camera(jvideo.decode_splatting))
    ex = {**example, "target": {k: v[:1] for k, v in example["target"].items()
                                if k != "index"}}
    jvalidation.run_validation_step(jitted(jenc), params, ex, HW,
                                    out_dir=tmp_path / "jax", step=2)
    cuda_lib.reset_launch_counts()
    validation.run_validation_step(tenc, ex, HW, out_dir=tmp_path / "torch",
                                   step=2)
    assert not any(cuda_lib.launches().values())
    assert "validation video skipped" not in capsys.readouterr().out
    for name in ("interpolation.gif", "wobble.gif"):
        frames = []
        for d in ("torch", "jax"):
            with Image.open(tmp_path / d / "validation/step_2" / name) as gif:
                frames.append((gif.n_frames, gif.size))
        assert frames[0] == frames[1] == (30 + 28, HW[::-1]), name


def test_validation_video_failure_is_reported(setup, tmp_path, monkeypatch,
                                              capsys):
    """Best effort, as in JAX: a failing video prints and returns the
    metrics."""
    example, _, _, tenc = setup
    from spfsplatv2_tpu_torch.evaluation import video

    def broken(*args, **kwargs):
        raise RuntimeError("no frames")

    monkeypatch.setattr(video, "render_interpolation_video", broken)
    ex = {**example, "target": {k: v[:1] for k, v in example["target"].items()
                                if k != "index"}}
    metrics = validation.run_validation_step(tenc, ex, HW, out_dir=tmp_path,
                                             step=1)
    assert "val/psnr" in metrics
    assert "validation video skipped: no frames" in capsys.readouterr().out
    assert (tmp_path / "validation/step_1/comparison.png").exists()
