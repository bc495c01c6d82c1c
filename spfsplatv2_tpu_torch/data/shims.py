"""Per-example data shims, host-side numpy (copy of
`spfsplatv2_tpu/data/shims.py`):
  * rescale + center-crop with the intrinsics fixup;
  * random horizontal-flip augmentation with the extrinsics reflected;
  * near/far from the context views' disparity (bounds shim) and a
    center crop to a multiple of the patch size (patch shim), library
    surface that no path of either package calls.
The JAX module defines `compute_depth_for_disparity` and
`apply_bounds_shim` twice; Python binds the second pair, which is the
one copied here.
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


def compute_depth_for_disparity(
    extrinsics: np.ndarray,    # (v, 4, 4) c2w
    intrinsics: np.ndarray,    # (v, 3, 3) normalized
    image_shape: tuple[int, int],
    disparity: float,
    delta_min: float = 1e-6,
) -> float:
    """Depth at which the maximum camera baseline subtends `disparity`
    pixels (reference: src/dataset/shims/bounds_shim.py:9-37)."""
    origins = extrinsics[:, :3, 3]
    deltas = np.linalg.norm(origins[None] - origins[:, None], axis=-1)
    baseline = max(float(deltas.max()), delta_min)

    h, w = image_shape
    pixel_size = np.asarray([1.0 / w, 1.0 / h], np.float32)
    per_view = np.einsum(
        "vij,j->vi", np.linalg.inv(intrinsics[:, :2, :2]), pixel_size
    )
    mean_pixel_size = float(per_view.mean())
    return baseline / (disparity * mean_pixel_size)


def apply_bounds_shim(
    example: dict, near_disparity: float, far_disparity: float
) -> dict:
    """Replace near/far with disparity-derived depth bounds from the
    context views (reference: bounds_shim.py:40-78; library surface for
    experiments, which the reference encoders never call)."""
    ctx = example["context"]
    h, w = ctx["image"].shape[1:3]
    near = compute_depth_for_disparity(
        np.asarray(ctx["extrinsics"]), np.asarray(ctx["intrinsics"]),
        (h, w), near_disparity,
    )
    far = compute_depth_for_disparity(
        np.asarray(ctx["extrinsics"]), np.asarray(ctx["intrinsics"]),
        (h, w), far_disparity,
    )
    out = dict(example)
    for side in ("context", "target"):
        views = dict(example[side])
        v = views["image"].shape[0]
        views["near"] = np.full((v,), near, np.float32)
        views["far"] = np.full((v,), far, np.float32)
        out[side] = views
    return out


def apply_patch_shim(example: dict, patch_size: int) -> dict:
    """Center-crop every view so (h, w) divide by `patch_size`, with the
    matching intrinsics fixup (reference: src/dataset/shims/patch_shim.py)."""

    def shim_views(views: dict) -> dict:
        images = np.asarray(views["image"])     # (v, h, w, 3)
        h, w = images.shape[1:3]
        assert h % 2 == 0 and w % 2 == 0, (h, w)
        h_new = (h // patch_size) * patch_size
        w_new = (w // patch_size) * patch_size
        row = (h - h_new) // 2
        col = (w - w_new) // 2
        images = images[:, row: row + h_new, col: col + w_new]
        intrinsics = np.asarray(views["intrinsics"]).copy()
        intrinsics[:, 0, 0] *= w / w_new
        intrinsics[:, 1, 1] *= h / h_new
        return {**views, "image": images, "intrinsics": intrinsics}

    return {
        **example,
        "context": shim_views(example["context"]),
        "target": shim_views(example["target"]),
    }
