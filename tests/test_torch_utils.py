"""The port's utilities against the JAX package's, on the CPU.

  * `utils/drawing.py`: points, lines and camera frustums, torch against
    JAX's numpy on the same seeded inputs, within 1e-5;
  * `utils/logger.py`: the JSONL records, the PNG and the GIF;
  * `utils/profiling.py`: `trace` writing a Chrome trace, and the
    card's busy time read from one (`device_ops`, `busy_us`);
  * `data/convert_dl3dv.py`: both converters on the same seeded
    nerfstudio-layout scenes (one with fewer than 10 frames, one without
    `transforms.json`): the same index and image bytes, camera rows
    within 1e-6.
"""

import json

import numpy as np
import torch

from spfsplatv2_tpu.data import convert_dl3dv as jconvert
from spfsplatv2_tpu.utils import drawing as jdrawing
from spfsplatv2_tpu_torch.data import convert_dl3dv
from spfsplatv2_tpu_torch.data.chunk_io import encode_jpeg, load_chunk
from spfsplatv2_tpu_torch.utils import drawing, logger, profiling

TOL = 1e-5


def _pose(rng, shift=0.5):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q * np.sign(np.linalg.det(q))
    m[:3, 3] = rng.uniform(-shift, shift, 3)
    return m


def test_draw_points_and_lines_match_jax():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    pts = rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    cols = rng.uniform(0, 1, (7, 3)).astype(np.float32)
    ranges = dict(x_range=(-1.2, 1.1), y_range=(-1.0, 1.3))
    for kwargs in (dict(radius=3.0), dict(radius=4.0, inner_radius=2.0)):
        want = jdrawing.draw_points(image, pts, cols, **kwargs, **ranges)
        got = drawing.draw_points(torch.from_numpy(image), pts, cols, **kwargs,
                                  **ranges)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # Pixel coordinates (no ranges) and one colour for all.
    pix = rng.uniform(0, 50, (5, 2)).astype(np.float32)
    want = jdrawing.draw_points(image, pix, (0.2, 0.9, 0.4), radius=2.5)
    got = drawing.draw_points(torch.from_numpy(image), pix, (0.2, 0.9, 0.4),
                              radius=2.5)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    start, end = pts[:4], pts[3:]
    want = jdrawing.draw_lines(image, start, end, cols[:4], width=2.0,
                               **ranges)
    got = drawing.draw_lines(torch.from_numpy(image), start, end, cols[:4],
                             width=2.0, **ranges)
    assert float(np.abs(want - image).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_draw_cameras_matches_jax():
    rng = np.random.default_rng(1)
    extr = np.stack([_pose(rng) for _ in range(4)])
    intr = np.broadcast_to(np.asarray([[0.9, 0, 0.5], [0, 1.1, 0.5],
                                       [0, 0, 1]], np.float32), (4, 3, 3))
    cols = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    want = jdrawing.draw_cameras(64, extr, intr, cols, frustum_scale=0.2)
    got = drawing.draw_cameras(64, torch.from_numpy(extr),
                               torch.from_numpy(intr.copy()), cols,
                               frustum_scale=0.2)
    assert got.shape == (3, 64, 64, 3) and float(got.max()) > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_local_logger_writes_records_images_and_videos(tmp_path):
    log = logger.LocalLogger(tmp_path, flush_every=2)
    log.log_scalars(0, {"loss/total": 0.5, "raster/dropped_entries": 3})
    log.log_scalars(1, {"loss/total": 0.25})
    frame = torch.linspace(0, 1, 8 * 8 * 3).reshape(8, 8, 3)
    log.log_image(1, "render", frame)
    log.log_video(1, "orbit", [frame, 1 - frame])
    log.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["step"] for r in records] == [0, 1]
    assert records[0]["loss/total"] == 0.5
    assert records[0]["raster/dropped_entries"] == 3
    assert records[1]["time"] >= records[0]["time"]
    from PIL import Image

    with Image.open(tmp_path / "images" / "render_00000001.png") as png:
        assert png.size == (8, 8)
        assert np.asarray(png)[-1, -1, -1] == 255
    with Image.open(tmp_path / "videos" / "orbit_00000001.gif") as gif:
        assert gif.n_frames == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "profile") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_busy_time_is_the_union_of_device_operations(tmp_path):
    """Kernels, memcpys and memsets count once where they overlap; the
    card's annotation rows and host events do not count."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("kernel", "k1", 10.0, 5.0), ev("kernel", "k2", 12.0, 5.0),
        ev("gpu_memcpy", "Memcpy HtoD", 20.0, 2.0),
        ev("gpu_memset", "Memset", 30.0, 1.0),
        ev("gpu_user_annotation", "Optimizer.step#AdamW.step", 0.0, 40.0),
        ev("cpu_op", "aten::mm", 0.0, 50.0),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5.0}]}))
    ops = profiling.device_ops(path)
    assert [n for _, _, n in ops] == ["k1", "k2", "Memcpy HtoD", "Memset"]
    assert profiling.busy_us(ops) == 10.0


def _nerfstudio_scene(root, name, n_frames, rng, with_transforms=True):
    scene = root / name
    (scene / "images").mkdir(parents=True)
    frames = []
    for i in range(n_frames):
        img = rng.uniform(0, 1, (18, 32, 3)).astype(np.float32)
        path = f"images/frame_{i:05d}.jpg"
        (scene / path).write_bytes(encode_jpeg(img))
        frames.append({"file_path": path,
                       "transform_matrix": _pose(rng, 2.0).tolist()})
    # One frame listed without its file, one with its own intrinsics.
    frames.append({"file_path": "images/missing.jpg",
                   "transform_matrix": np.eye(4).tolist()})
    frames[0].update(fl_x=30.5, fl_y=29.0, cx=16.2, cy=8.9)
    rng.shuffle(frames)
    if with_transforms:
        (scene / "transforms.json").write_text(json.dumps({
            "w": 32, "h": 18, "fl_x": 28.1, "fl_y": 27.3, "cx": 15.9,
            "cy": 9.1, "frames": frames}))


def test_convert_dl3dv_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    src = tmp_path / "src"
    for i, n in enumerate((12, 11, 9, 13)):
        _nerfstudio_scene(src, f"scene_{i}", n, rng)
    _nerfstudio_scene(src, "scene_9", 12, rng, with_transforms=False)
    (src / "notes.txt").write_text("not a scene")
    # 0 MB chunks: one scene a chunk.
    ours = convert_dl3dv.convert_dataset(src, tmp_path / "ours", "train", 0)
    theirs = jconvert.convert_dataset(src, tmp_path / "jax", "train", 0)
    assert ours == theirs
    assert sorted(ours) == ["scene_0", "scene_1", "scene_3"]
    assert sorted(set(ours.values())) == ["000000.torch", "000001.torch",
                                          "000002.torch"]
    assert (json.loads((tmp_path / "ours" / "index_train.json").read_text())
            == ours)
    for name in sorted(set(ours.values())):
        a = load_chunk(tmp_path / "ours" / "train" / name)
        b = load_chunk(tmp_path / "jax" / "train" / name)
        assert [e["key"] for e in a] == [e["key"] for e in b]
        for x, y in zip(a, b):
            assert x["images"] == y["images"]
            np.testing.assert_allclose(x["cameras"], y["cameras"], atol=1e-6)
    # The command line, into one chunk.
    convert_dl3dv.main([str(src), str(tmp_path / "cli"), "--stage", "test"])
    assert sorted(set(json.loads((tmp_path / "cli" / "index_test.json")
                                 .read_text()).values())) == ["000000.torch"]
