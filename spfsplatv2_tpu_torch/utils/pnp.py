"""PnP-from-pointmap pose estimation through the repository's native
solver (torch port of `spfsplatv2_tpu/utils/pnp.py`).

Given a predicted per-pixel pointmap and opacities, the camera pose is
recovered from 3D -> pixel correspondences by DLT-RANSAC and Gauss-Newton
refinement in `native/pnp.cc`.  The port compiles that source with `g++`
(the flags of `native/Makefile`) into `build/native/libpnp-<hash>.so` at
first use, the hash taken over the source, and loads it with `ctypes`.
It is the only backend: a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "pnp.cc"
BUILD_DIR = REPO_DIR / "build" / "native"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
_D = ctypes.POINTER(ctypes.c_double)


@dataclass(frozen=True)
class NativePnP:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float | None   # None: the library was already built


@functools.cache
def native_library() -> NativePnP:
    """The loaded solver, built on first use."""
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libpnp-{h}.so"
    seconds = None
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: native/pnp.cc cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE} (rc "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    lib.pnp_ransac.restype = ctypes.c_int
    lib.pnp_ransac.argtypes = [
        _D, _D, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_uint64,
        _D, ctypes.POINTER(ctypes.c_uint8),
    ]
    return NativePnP(lib, out, seconds)


def pnp_ransac(
    pts3d: np.ndarray,
    pixels: np.ndarray,
    k_px: np.ndarray,
    iterations: int = 100,
    reprojection_error: float = 5.0,
    seed: int = 0,
):
    """Solve the pose from (n, 3) world points and (n, 2) pixel coords.

    Returns (success, c2w (4, 4) float32).
    """
    pts3d = np.ascontiguousarray(pts3d, np.float64)
    pixels = np.ascontiguousarray(pixels, np.float64)
    n = pts3d.shape[0]
    if n < 6:
        return False, np.eye(4, dtype=np.float32)

    fx, fy = k_px[0, 0], k_px[1, 1]
    cx, cy = k_px[0, 2], k_px[1, 2]
    uv = np.ascontiguousarray(
        np.stack([(pixels[:, 0] - cx) / fx, (pixels[:, 1] - cy) / fy], axis=-1),
        np.float64)
    w2c = np.zeros((4, 4), np.float64)
    inliers = np.zeros((n,), np.uint8)
    # Normalized-coordinate threshold from the pixel threshold.
    thresh = reprojection_error / float((abs(fx) + abs(fy)) / 2)
    ok = native_library().lib.pnp_ransac(
        pts3d.ctypes.data_as(_D), uv.ctypes.data_as(_D), n, iterations, thresh,
        seed, w2c.ctypes.data_as(_D),
        inliers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if not ok:
        return False, np.eye(4, dtype=np.float32)
    return True, np.linalg.inv(w2c).astype(np.float32)


def pnp_pose_from_pointmap(
    pts3d: np.ndarray,        # (h, w, 3)
    opacity: np.ndarray,      # (h, w)
    k_norm: np.ndarray,       # (3, 3) normalized intrinsics
    opacity_threshold: float = 0.3,
) -> np.ndarray:
    """Pointmap + opacity -> c2w (4, 4); identity when it fails."""
    h, w = opacity.shape
    k_px = k_norm.copy()
    k_px[0, :] *= w
    k_px[1, :] *= h
    ys, xs = np.mgrid[:h, :w]
    mask = opacity > opacity_threshold
    if mask.sum() < 6:
        return np.eye(4, dtype=np.float32)
    pts = pts3d[mask].reshape(-1, 3)
    pix = np.stack([xs[mask], ys[mask]], axis=-1).astype(np.float64)
    ok, c2w = pnp_ransac(pts, pix, k_px)
    return c2w if ok else np.eye(4, dtype=np.float32)
