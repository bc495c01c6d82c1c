"""DL3DV-480p -> chunked `.torch` dataset converter (torch port of
`spfsplatv2_tpu/data/convert_dl3dv.py`).

Reads each scene's `transforms.json` (nerfstudio convention: OpenGL
camera-to-world, fl_x / fl_y / cx / cy in pixels) and its frame images,
normalizes the intrinsics, converts the poses to the chunk format's
OpenCV world-to-camera 18-float rows, and packs chunks of about
`--chunk-mb` megabytes of image bytes through `data/chunk_io.save_chunk`.
Scenes without `transforms.json`, or with fewer than 10 frames on disk,
are left out.

Usage:
    python -m spfsplatv2_tpu_torch.data.convert_dl3dv <input_root> \
        <output_root> [--stage train] [--chunk-mb 200]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from spfsplatv2_tpu_torch.data.chunk_io import save_chunk

# OpenGL (nerfstudio) -> OpenCV camera axes: flip y and z.
GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
MIN_FRAMES = 10


def convert_scene(scene_dir: Path) -> dict | None:
    """One scene directory -> {"key", "cameras" (n, 18), "images"
    (encoded bytes)}, or None when it has no `transforms.json` or fewer
    than `MIN_FRAMES` frames on disk."""
    tf_path = scene_dir / "transforms.json"
    if not tf_path.exists():
        return None
    meta = json.loads(tf_path.read_text())
    w, h = meta.get("w"), meta.get("h")

    cameras, images = [], []
    frames = sorted(meta["frames"], key=lambda f: f["file_path"])
    for frame in frames:
        img_path = scene_dir / frame["file_path"]
        if not img_path.exists():
            continue
        fx = frame.get("fl_x", meta.get("fl_x"))
        fy = frame.get("fl_y", meta.get("fl_y"))
        cx = frame.get("cx", meta.get("cx"))
        cy = frame.get("cy", meta.get("cy"))
        fw = frame.get("w", w)
        fh = frame.get("h", h)

        c2w = np.asarray(frame["transform_matrix"], np.float32) @ GL_TO_CV
        w2c = np.linalg.inv(c2w)

        row = np.zeros((18,), np.float32)
        row[:4] = [fx / fw, fy / fh, cx / fw, cy / fh]
        row[6:] = w2c[:3].reshape(-1)
        cameras.append(row)
        images.append(img_path.read_bytes())

    if len(images) < MIN_FRAMES:
        return None
    return {"key": scene_dir.name, "cameras": np.stack(cameras),
            "images": images}


def convert_dataset(input_root: str | Path, output_root: str | Path,
                    stage: str = "train", target_chunk_mb: int = 200) -> dict:
    """Convert every scene directory under `input_root` into
    `<output_root>/<stage>/NNNNNN.torch` chunks; writes and returns the
    index {scene key: chunk file name} (`<output_root>/index_<stage>.json`).
    """
    input_root, output_root = Path(input_root), Path(output_root)
    out_dir = output_root / stage
    out_dir.mkdir(parents=True, exist_ok=True)

    index: dict = {}
    chunk: list = []
    chunk_bytes = 0
    chunk_id = 0

    def flush():
        nonlocal chunk, chunk_bytes, chunk_id
        if not chunk:
            return
        name = f"{chunk_id:06d}.torch"
        save_chunk(chunk, out_dir / name)
        for ex in chunk:
            index[ex["key"]] = name
        chunk, chunk_bytes = [], 0
        chunk_id += 1

    for scene_dir in sorted(p for p in input_root.iterdir() if p.is_dir()):
        example = convert_scene(scene_dir)
        if example is None:
            continue
        chunk.append(example)
        chunk_bytes += sum(len(b) for b in example["images"])
        if chunk_bytes >= target_chunk_mb * 1024 * 1024:
            flush()
    flush()

    (output_root / f"index_{stage}.json").write_text(json.dumps(index,
                                                                indent=2))
    return index


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input_root")
    parser.add_argument("output_root")
    parser.add_argument("--stage", default="train")
    parser.add_argument("--chunk-mb", type=int, default=200)
    args = parser.parse_args(argv)
    index = convert_dataset(args.input_root, args.output_root, args.stage,
                            args.chunk_mb)
    print(f"converted {len(index)} scenes")


if __name__ == "__main__":
    main()
