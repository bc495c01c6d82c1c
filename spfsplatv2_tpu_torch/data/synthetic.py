"""Synthetic scene generator producing reference-format chunks (copy of
`spfsplatv2_tpu/data/synthetic.py`).

Renders simple coloured-blob scenes from a smooth camera trajectory and
writes them as `.torch` chunk files in the format `data/chunk_io.py`
reads, so the data pipeline runs without real RE10K data.  The same
arguments give the same bytes as the JAX package's writer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spfsplatv2_tpu_torch.data.chunk_io import encode_jpeg, save_chunk


def _look_at_trajectory(n: int, radius: float, rng) -> np.ndarray:
    """Smooth c2w trajectory orbiting slightly while looking at origin."""
    poses = []
    for i in range(n):
        t = i / max(n - 1, 1)
        eye = np.asarray(
            [radius * 0.4 * np.sin(0.8 * t), 0.1 * np.cos(1.3 * t), -radius + 0.5 * t]
        )
        forward = -eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(up, forward)
        right /= np.linalg.norm(right)
        up2 = np.cross(forward, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, forward, eye
        poses.append(c2w)
    return np.stack(poses)


def _render_blob_image(
    c2w: np.ndarray, k_norm: np.ndarray, blobs, hw: tuple[int, int]
) -> np.ndarray:
    """Crude painter's-algorithm render of Gaussian color blobs."""
    h, w = hw
    img = np.full((h, w, 3), 0.08, np.float32)
    w2c = np.linalg.inv(c2w)
    order = []
    for center, color, size in blobs:
        cam = w2c[:3, :3] @ center + w2c[:3, 3]
        if cam[2] > 0.1:
            order.append((cam[2], cam, color, size))
    ys, xs = np.mgrid[0:h, 0:w]
    for depth, cam, color, size in sorted(order, key=lambda t: -t[0]):
        fx, fy = k_norm[0, 0] * w, k_norm[1, 1] * h
        cx, cy = k_norm[0, 2] * w, k_norm[1, 2] * h
        px = fx * cam[0] / cam[2] + cx
        py = fy * cam[1] / cam[2] + cy
        r2 = ((xs - px) ** 2 + (ys - py) ** 2) / (size * fx / cam[2]) ** 2
        weight = np.exp(-0.5 * r2)[..., None]
        img = img * (1 - weight) + color[None, None] * weight
    return np.clip(img, 0.0, 1.0)


def generate_scene(
    key: str,
    num_frames: int = 60,
    image_hw: tuple[int, int] = (360, 640),
    num_blobs: int = 40,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    blobs = [
        (
            np.asarray([*rng.uniform(-1.5, 1.5, 2), rng.uniform(1.0, 4.0)]),
            rng.uniform(0.1, 1.0, 3).astype(np.float32),
            rng.uniform(0.05, 0.25),
        )
        for _ in range(num_blobs)
    ]
    poses_c2w = _look_at_trajectory(num_frames, radius=3.0, rng=rng)
    h, w = image_hw
    k_norm = np.asarray(
        [[0.8 * h / w if w > h else 0.8, 0, 0.5], [0, 0.8, 0.5], [0, 0, 1]],
        np.float32,
    )
    k_norm[0, 0] = 0.8 * h / w  # square pixels in normalized units

    cameras = np.zeros((num_frames, 18), np.float32)
    images = []
    for i in range(num_frames):
        cameras[i, :4] = [k_norm[0, 0], k_norm[1, 1], 0.5, 0.5]
        w2c = np.linalg.inv(poses_c2w[i])
        cameras[i, 6:] = w2c[:3].reshape(-1)
        images.append(encode_jpeg(_render_blob_image(poses_c2w[i], k_norm, blobs, image_hw)))
    return {"key": key, "cameras": cameras, "images": images}


def write_synthetic_dataset(
    root: str | Path,
    num_scenes: int = 2,
    num_frames: int = 60,
    image_hw: tuple[int, int] = (360, 640),
    stage: str = "train",
    processes: int = 0,
) -> Path:
    """Write `num_scenes` scenes into `<root>/<stage>/000000.torch`.

    `processes` > 0 renders the scenes in that many worker processes
    (spawned); the chunk's bytes do not depend on it.
    """
    root = Path(root) / stage
    root.mkdir(parents=True, exist_ok=True)
    args = [(f"scene_{i:03d}", num_frames, image_hw, 40, i)
            for i in range(num_scenes)]
    if processes > 0:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes) as pool:
            examples = pool.starmap(generate_scene, args)
    else:
        examples = [generate_scene(*a) for a in args]
    save_chunk(examples, root / "000000.torch")
    return root.parent
