"""Visualization helpers: image layout, depth colormap, image saving
(the parts of `spfsplatv2_tpu/utils/visualization.py` that validation and
evaluation use).  Host-side numpy; PNG writing uses Pillow, imported
where it is needed.  Video export is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def hcat(*images: np.ndarray, border: int = 4, value: float = 1.0) -> np.ndarray:
    """Concatenate (h, w, 3) images horizontally with a border."""
    h = max(im.shape[0] for im in images)
    pieces = []
    for i, im in enumerate(images):
        if im.shape[0] != h:
            pad = np.full((h - im.shape[0], im.shape[1], 3), value, im.dtype)
            im = np.concatenate([im, pad], axis=0)
        if i:
            pieces.append(np.full((h, border, 3), value, im.dtype))
        pieces.append(im)
    return np.concatenate(pieces, axis=1)


def vcat(*images: np.ndarray, border: int = 4, value: float = 1.0) -> np.ndarray:
    return np.transpose(
        hcat(*[np.transpose(im, (1, 0, 2)) for im in images], border=border,
             value=value),
        (1, 0, 2),
    )


_TURBO_ANCHORS = np.asarray(
    [
        [0.19, 0.07, 0.23],
        [0.28, 0.26, 0.71],
        [0.15, 0.58, 0.96],
        [0.10, 0.86, 0.64],
        [0.47, 0.99, 0.21],
        [0.84, 0.88, 0.10],
        [0.99, 0.60, 0.08],
        [0.90, 0.27, 0.05],
        [0.61, 0.06, 0.01],
    ],
    np.float32,
)


def apply_depth_colormap(
    depth: np.ndarray, near: float | None = None, far: float | None = None
) -> np.ndarray:
    """(h, w) depth -> (h, w, 3) colormapped image (log-scaled, turbo-like)."""
    d = np.asarray(depth, np.float32)
    lo = np.log(max(near if near is not None else np.percentile(d, 1), 1e-6))
    hi = np.log(max(far if far is not None else np.percentile(d, 99), 1e-6))
    t = np.clip((np.log(np.maximum(d, 1e-6)) - lo) / max(hi - lo, 1e-6), 0, 1)
    x = t * (len(_TURBO_ANCHORS) - 1)
    i0 = np.clip(x.astype(np.int32), 0, len(_TURBO_ANCHORS) - 2)
    frac = (x - i0)[..., None]
    return _TURBO_ANCHORS[i0] * (1 - frac) + _TURBO_ANCHORS[i0 + 1] * frac


def save_image(image: np.ndarray, path: str | Path) -> None:
    """(h, w, 3) float image -> 8-bit PNG of clip(255 * image), truncated
    to an integer as the JAX package's writer does."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.clip(image * 255, 0, 255).astype(np.uint8)).save(path)
