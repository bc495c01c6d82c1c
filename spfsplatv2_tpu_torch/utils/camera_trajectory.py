"""Camera trajectories for videos: wobble, spin, intrinsics lerp (torch
port of `spfsplatv2_tpu/utils/camera_trajectory.py`).

Host-side numpy: they produce a handful of 4x4 matrices a video, and
rendering the trajectory goes through the decoder.  The pose
interpolation `utils.visualization.interpolate_extrinsics` is
re-exported here for a single import surface.
"""

from __future__ import annotations

import numpy as np

from spfsplatv2_tpu_torch.utils.visualization import interpolate_extrinsics

__all__ = [
    "generate_wobble_transformation",
    "generate_wobble",
    "generate_spin",
    "interpolate_intrinsics",
    "interpolate_extrinsics",
]


def generate_wobble_transformation(
    radius: np.ndarray | float,
    t: np.ndarray,
    num_rotations: int = 1,
    scale_radius_with_t: bool = True,
) -> np.ndarray:
    """Circular in-image-plane translation.

    radius: (...,) wobble radius; t: (n,) in [0, 1].
    Returns (..., n, 4, 4) transforms.
    """
    radius = np.asarray(radius, np.float32)
    t = np.asarray(t, np.float32)
    tf = np.broadcast_to(
        np.eye(4, dtype=np.float32), (*radius.shape, t.shape[0], 4, 4)
    ).copy()
    r = radius[..., None]
    if scale_radius_with_t:
        r = r * t
    tf[..., 0, 3] = np.sin(2 * np.pi * num_rotations * t) * r
    tf[..., 1, 3] = -np.cos(2 * np.pi * num_rotations * t) * r
    return tf


def generate_wobble(
    extrinsics: np.ndarray,   # (..., 4, 4) c2w
    radius: np.ndarray | float,
    t: np.ndarray,
) -> np.ndarray:
    """Wobble the camera about its own pose."""
    tf = generate_wobble_transformation(radius, t)
    return np.asarray(extrinsics, np.float32)[..., None, :, :] @ tf


def _rotvec_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues formula; rotvec (..., 3) -> (..., 3, 3)."""
    theta = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    axis = rotvec / np.maximum(theta, 1e-12)
    k = np.zeros((*rotvec.shape[:-1], 3, 3), np.float32)
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    k[..., 0, 1], k[..., 0, 2] = -az, ay
    k[..., 1, 0], k[..., 1, 2] = az, -ax
    k[..., 2, 0], k[..., 2, 1] = -ay, ax
    th = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), k.shape)
    return eye + np.sin(th) * k + (1.0 - np.cos(th)) * (k @ k)


def generate_spin(
    num_frames: int,
    elevation: float,
    radius: float,
) -> np.ndarray:
    """Orbit trajectory: cameras on a circle of
    `radius` at `elevation` degrees looking at the origin.
    Returns (num_frames, 4, 4) c2w matrices."""
    tf_translation = np.eye(4, dtype=np.float32)
    tf_translation[:2] *= -1
    tf_translation[2, 3] = -radius

    phi = 2 * np.pi * (np.arange(num_frames) / num_frames)
    rotvecs = np.stack([np.zeros_like(phi), phi, np.zeros_like(phi)], -1)
    tf_azimuth = np.broadcast_to(
        np.eye(4, dtype=np.float32), (num_frames, 4, 4)
    ).copy()
    tf_azimuth[:, :3, :3] = _rotvec_to_matrix(rotvecs.astype(np.float32))

    tf_elevation = np.eye(4, dtype=np.float32)
    tf_elevation[:3, :3] = _rotvec_to_matrix(
        np.asarray([np.deg2rad(elevation), 0, 0], np.float32)
    )
    return tf_azimuth @ tf_elevation @ tf_translation


def interpolate_intrinsics(
    initial: np.ndarray,   # (..., 3, 3)
    final: np.ndarray,     # (..., 3, 3)
    t: np.ndarray,         # (n,)
) -> np.ndarray:
    """Linear intrinsics interpolation.
    Returns (..., n, 3, 3)."""
    initial = np.asarray(initial, np.float32)[..., None, :, :]
    final = np.asarray(final, np.float32)[..., None, :, :]
    t = np.asarray(t, np.float32)[:, None, None]
    return initial + (final - initial) * t
