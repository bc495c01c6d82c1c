"""Per-example data shims, host-side numpy (copy of the parts of
`spfsplatv2_tpu/data/shims.py` that the dataset applies):
  * rescale + center-crop with the intrinsics fixup;
  * random horizontal-flip augmentation with the extrinsics reflected.
The bounds and patch shims, which no path of the port calls, are not
copied.
"""

from __future__ import annotations

import numpy as np


def rescale_image(image: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """LANCZOS resample (h, w, 3) to `shape`; returns float32 [0, 1].

    Accepts float [0, 1] or uint8 [0, 255] input; the resample quantizes
    to uint8 either way.
    """
    from PIL import Image

    h, w = shape
    if image.dtype == np.uint8:
        arr = image
    else:
        arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    out = Image.fromarray(arr).resize((w, h), Image.LANCZOS)
    return np.asarray(out, dtype=np.float32) / 255.0


def center_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    """images (v, h, w, 3), normalized intrinsics (v, 3, 3)."""
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[:, row: row + h_out, col: col + w_out]
    intrinsics = intrinsics.copy()
    intrinsics[:, 0, 0] *= w_in / w_out
    intrinsics[:, 1, 1] *= h_in / h_out
    return images, intrinsics


def rescale_and_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    assert h_out <= h_in and w_out <= w_in
    scale = max(h_out / h_in, w_out / w_in)
    h_scaled, w_scaled = round(h_in * scale), round(w_in * scale)
    images = np.stack([rescale_image(im, (h_scaled, w_scaled)) for im in images])
    return center_crop(images, intrinsics, shape)


def apply_crop_shim(example: dict, shape: tuple[int, int]) -> dict:
    out = dict(example)
    for side in ("context", "target"):
        views = dict(example[side])
        views["image"], views["intrinsics"] = rescale_and_crop(
            views["image"], views["intrinsics"], shape
        )
        out[side] = views
    return out


def reflect_extrinsics(extrinsics: np.ndarray) -> np.ndarray:
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1
    return reflect @ extrinsics @ reflect


def apply_augmentation(example: dict, rng: np.random.Generator) -> dict:
    """50% random horizontal flip of images + mirrored extrinsics."""
    if rng.random() < 0.5:
        return example
    out = dict(example)
    for side in ("context", "target"):
        views = dict(example[side])
        views["image"] = views["image"][:, :, ::-1].copy()
        views["extrinsics"] = reflect_extrinsics(views["extrinsics"])
        out[side] = views
    return out
