"""SE(3)/SO(3) algebra and camera-pose utilities (torch port).

Counterpart of `spfsplatv2_tpu/geometry/se3.py`, restricted to the
functions the inference path uses.  Extrinsics are camera-to-world (c2w)
4x4 matrices; quaternions are (w, x, y, z).
"""

from __future__ import annotations

import torch


def quaternion_to_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def rotation_6d_to_matrix(d6: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """6D rotation (first two rows) -> (..., 3, 3) via Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + eps)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / (torch.linalg.norm(a2, dim=-1, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def pack_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    bottom = bottom.expand(*r.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def inverse_se3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform (..., 4, 4)."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    rt = r.transpose(-1, -2)
    return pack_rt(rt, -(rt @ t[..., None])[..., 0])


def pose_encoding_to_matrix(enc: torch.Tensor) -> torch.Tensor:
    """9D pose encoding [6D rot | 3D t] -> (..., 4, 4) c2w."""
    return pack_rt(rotation_6d_to_matrix(enc[..., :6]), enc[..., 6:9])


def camera_normalization(pivot: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Re-express `poses` so that `pivot` becomes identity."""
    return inverse_se3(pivot) @ poses


def depth_from_pose(pts3d: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """Per-point camera-frame z: (..., n, 3), (..., 4, 4) -> (..., n)."""
    w2c = inverse_se3(c2w)
    cam = (
        torch.einsum("...ij,...nj->...ni", w2c[..., :3, :3], pts3d)
        + w2c[..., None, :3, 3]
    )
    return cam[..., 2]


def rotation_angle_deg(r1: torch.Tensor, r2: torch.Tensor,
                       eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotations in degrees."""
    m = r1 @ r2.transpose(-1, -2)
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cos = torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps)
    return torch.rad2deg(torch.arccos(cos))


def translation_angle_deg(t1: torch.Tensor, t2: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Angle between translation directions (degrees), 180-deg ambiguous."""
    n1 = t1 / (torch.linalg.norm(t1, dim=-1, keepdim=True) + eps)
    n2 = t2 / (torch.linalg.norm(t2, dim=-1, keepdim=True) + eps)
    cos = torch.clamp(torch.abs(torch.sum(n1 * n2, dim=-1)), 0.0, 1.0 - 1e-7)
    return torch.rad2deg(torch.arccos(cos))
