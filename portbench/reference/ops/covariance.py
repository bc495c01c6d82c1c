"""3D covariance from scales + quaternions (torch port of
`spfsplatv2_tpu/ops/covariance.py`)."""

from __future__ import annotations

import torch


def build_covariance(scale: torch.Tensor, rotation_wxyz: torch.Tensor) -> torch.Tensor:
    """scale (..., 3), quaternion (..., 4) -> covariance (..., 3, 3).

    Sigma = R S S^T R^T with S = diag(scale), unrolled over the 3x3
    components exactly as the JAX function does.
    """
    q = rotation_wxyz / (
        torch.linalg.norm(rotation_wxyz, dim=-1, keepdim=True) + 1e-8
    )
    qw, qx, qy, qz = q.unbind(-1)
    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ]
    s2 = [scale[..., k] * scale[..., k] for k in range(3)]
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            if j < i:
                row.append(rows[j][i])
            else:
                row.append(sum(r[i][k] * s2[k] * r[j][k] for k in range(3)))
        rows.append(row)
    flat = torch.stack([rows[i][j] for i in range(3) for j in range(3)], dim=-1)
    return flat.reshape(*scale.shape[:-1], 3, 3)
