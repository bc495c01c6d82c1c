"""Visualization helpers: image layout, depth colormap, pose
interpolation, image and video saving (torch port of
`spfsplatv2_tpu/utils/visualization.py`).  Host-side numpy (the pose
interpolation's SE(3) algebra in torch on the CPU); PNG and GIF writing
use Pillow, imported where it is needed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


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


def interpolate_extrinsics(
    a: np.ndarray, b: np.ndarray, t: np.ndarray
) -> np.ndarray:
    """Pose interpolation by the relative rotation's axis-angle and a
    translation lerp, as the JAX function does it.

    a, b: (4, 4) c2w; t: (n,), in [0, 1] or beyond it (extrapolation)
    -> (n, 4, 4) float32.  The relative pose and each frame's rotation
    are float32; each frame's relative transform is float64, and
    a @ m is cast to float32 at the end.
    """
    from spfsplatv2_tpu_torch.geometry import se3

    a32 = torch.as_tensor(np.asarray(a, np.float32))
    b32 = torch.as_tensor(np.asarray(b, np.float32))
    rel = (se3.inverse_se3(a32) @ b32).numpy()
    q = se3.matrix_to_quaternion(torch.as_tensor(rel[:3, :3])).numpy()
    angle = 2 * np.arccos(np.clip(q[0], -1, 1))
    axis = q[1:] / (np.linalg.norm(q[1:]) + 1e-12)
    t = np.asarray(t, np.float32)
    rots = se3.so3_exp(torch.as_tensor(axis[None] * angle * t[:, None])).numpy()
    m = np.broadcast_to(np.eye(4), (t.shape[0], 4, 4)).copy()
    m[:, :3, :3] = rots
    m[:, :3, 3] = rel[None, :3, 3] * t[:, None]
    return (np.asarray(a) @ m).astype(np.float32)


def save_video(frames: list[np.ndarray], path: str | Path, fps: int = 30) -> None:
    """Save (h, w, 3) float [0, 1] frames as an animated GIF at
    `path.with_suffix(".gif")`, looping, `int(1000 / fps)` ms a frame."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    imgs = [
        Image.fromarray(np.clip(f * 255, 0, 255).astype(np.uint8)) for f in frames
    ]
    imgs[0].save(
        path.with_suffix(".gif"),
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )


def save_image(image: np.ndarray, path: str | Path) -> None:
    """(h, w, 3) float image -> 8-bit PNG of clip(255 * image), truncated
    to an integer as the JAX package's writer does."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.clip(image * 255, 0, 255).astype(np.uint8)).save(path)
