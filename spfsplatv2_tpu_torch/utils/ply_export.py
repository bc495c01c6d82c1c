"""Gaussians -> 3DGS-standard binary PLY (torch port of
`spfsplatv2_tpu/utils/ply_export.py`; no plyfile dependency).

The export recentres the means on their centroid, scales so that the
95th-percentile radius is 1, applies the viewer's axis swizzle to means
and rotations, keeps only the DC band of the harmonics, and writes the
logit of the opacity and the log of the scales as little-endian float32
rows under the same header, byte for byte.  The arithmetic runs in torch
on the device of the inputs (tensors stay on the card; numpy arrays go
through the CPU).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spfsplatv2_tpu_torch.geometry.se3 import (
    matrix_to_quaternion,
    quaternion_to_matrix,
)

PROPERTIES = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)
# The swizzle [[0, 0, 1], [1, 0, 0], [0, 1, 0]] applied on the left:
# row i of the result is row SWIZZLE[i] of its input.
SWIZZLE = [2, 0, 1]


def ply_header(g: int) -> bytes:
    return (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {g}\n"
        + "".join(f"property float {p}\n" for p in PROPERTIES)
        + "end_header\n"
    ).encode("ascii")


@torch.no_grad()
def export_ply(
    means,       # (g, 3)
    scales,      # (g, 3)
    rotations,   # (g, 4) wxyz
    harmonics,   # (g, 3, d_sh)
    opacities,   # (g,)
    path: str | Path,
) -> None:
    """Write `path`: numpy arrays or tensors, on any device."""
    f32 = lambda x: torch.as_tensor(x).to(torch.float32)  # noqa: E731
    means, scales, rotations = f32(means), f32(scales), f32(rotations)
    harmonics, opacities = f32(harmonics), f32(opacities)

    # Shift the centroid to the origin, the 95th-percentile radius to 1.
    means = means - means.mean(dim=0)
    scale_factor = torch.quantile(torch.linalg.norm(means, dim=-1), 0.95)
    scale_factor = max(float(scale_factor), 1e-8)
    means = means / scale_factor
    scales = scales / scale_factor

    means = means[:, SWIZZLE]
    rot_mats = quaternion_to_matrix(rotations)[:, SWIZZLE, :]
    rotations = matrix_to_quaternion(rot_mats)

    op = torch.clamp(opacities, 1e-6, 1 - 1e-6)
    data = torch.cat(
        [
            means,
            torch.zeros_like(means),                  # normals
            harmonics[:, :, 0],                       # DC band only
            torch.log(op / (1 - op))[:, None],        # logit(opacity)
            torch.log(torch.clamp(scales, min=1e-10)),
            rotations,
        ],
        dim=-1,
    ).cpu().numpy().astype("<f4")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(ply_header(data.shape[0]))
        f.write(data.tobytes())


def load_ply(path: str | Path) -> dict:
    """Read back a file of `export_ply` (numpy columns, activations
    applied: opacity sigmoid, scale exp)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
        props = [l.split()[-1] for l in lines if l.startswith("property")]
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, len(props))
    cols = {p: data[:, i] for i, p in enumerate(props)}
    return {
        "means": np.stack([cols["x"], cols["y"], cols["z"]], -1),
        "harmonics_dc": np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1),
        "opacities": 1 / (1 + np.exp(-cols["opacity"])),
        "scales": np.exp(np.stack([cols[f"scale_{i}"] for i in range(3)], -1)),
        "rotations": np.stack([cols[f"rot_{i}"] for i in range(4)], -1),
    }
