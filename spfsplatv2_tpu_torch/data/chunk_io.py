"""Chunk file IO: the reference's `.torch` chunk format (copy of
`spfsplatv2_tpu/data/chunk_io.py`).

A chunk is a list of examples {key, cameras (n, 18) float32, images: list
of JPEG byte tensors}, read with `torch.load(..., weights_only=True)` and
decoded into numpy.  Camera rows are [fx fy cx cy 0 0 | 3x4 w2c row-major]
with normalized intrinsics.  JPEG coding uses Pillow, imported where it
is needed.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import torch


def load_chunk(path: str | Path) -> list[dict]:
    """Load one chunk file -> list of {key, cameras(np), images(list[bytes])}."""
    raw = torch.load(path, weights_only=True, map_location="cpu")
    out = []
    for example in raw:
        images = [
            bytes(img.numpy().tobytes()) if hasattr(img, "numpy") else bytes(img)
            for img in example["images"]
        ]
        out.append(
            {
                "key": example["key"],
                "cameras": np.asarray(example["cameras"], dtype=np.float32),
                "images": images,
            }
        )
    return out


def save_chunk(examples: list[dict], path: str | Path) -> None:
    """Write a chunk in the reference format (for converters and tests)."""
    serializable = []
    for ex in examples:
        serializable.append(
            {
                "key": ex["key"],
                "cameras": torch.from_numpy(
                    np.asarray(ex["cameras"], dtype=np.float32)
                ),
                "images": [
                    torch.from_numpy(np.frombuffer(img, dtype=np.uint8).copy())
                    for img in ex["images"]
                ],
            }
        )
    torch.save(serializable, path)


def decode_poses(cameras: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, 18) camera rows -> (c2w (n, 4, 4), normalized K (n, 3, 3))."""
    n = cameras.shape[0]
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    fx, fy, cx, cy = cameras[:, 0], cameras[:, 1], cameras[:, 2], cameras[:, 3]
    intrinsics[:, 0, 0] = fx
    intrinsics[:, 1, 1] = fy
    intrinsics[:, 0, 2] = cx
    intrinsics[:, 1, 2] = cy

    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, :3] = cameras[:, 6:].reshape(n, 3, 4)
    c2w = np.linalg.inv(w2c)
    return c2w, intrinsics


def decode_jpeg_u8(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) uint8 (the cheap form; convert late)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert("RGB"))


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) float32 in [0, 1]."""
    return decode_jpeg_u8(data).astype(np.float32) / 255.0


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """(h, w, 3) float [0, 1] -> JPEG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()
