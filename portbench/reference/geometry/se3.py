"""SE(3)/SO(3) algebra and camera-pose utilities (torch port).

Counterpart of `spfsplatv2_tpu/geometry/se3.py` (its host-side
`pose_auc` lives in `evaluation/metrics.py`).  Extrinsics are
camera-to-world (c2w) 4x4 matrices; quaternions are (w, x, y, z).
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


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion (w >= 0).

    Branch-free Shepperd's method: all four candidate constructions are
    built and the one with the largest 4 q_i^2 is gathered per matrix.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = torch.clamp(1 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1 - m00 - m11 + m22, min=0.0)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)

    w = 0.5 * torch.sqrt(qw2 + 1e-24)
    x = 0.5 * torch.sqrt(qx2 + 1e-24)
    y = 0.5 * torch.sqrt(qy2 + 1e-24)
    z = 0.5 * torch.sqrt(qz2 + 1e-24)
    qs = torch.stack([
        torch.stack([w, (m21 - m12) / (4 * w), (m02 - m20) / (4 * w),
                     (m10 - m01) / (4 * w)], dim=-1),
        torch.stack([(m21 - m12) / (4 * x), x, (m01 + m10) / (4 * x),
                     (m02 + m20) / (4 * x)], dim=-1),
        torch.stack([(m02 - m20) / (4 * y), (m01 + m10) / (4 * y), y,
                     (m12 + m21) / (4 * y)], dim=-1),
        torch.stack([(m10 - m01) / (4 * z), (m02 + m20) / (4 * z),
                     (m12 + m21) / (4 * z), z], dim=-1),
    ], dim=-2)                                          # (..., 4, 4)
    index = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(qs, -2, index)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotation_6d_to_matrix(d6: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """6D rotation (first two rows) -> (..., 3, 3) via Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + eps)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / (torch.linalg.norm(a2, dim=-1, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, flattened (the
    inverse of `rotation_6d_to_matrix` on rotations)."""
    return m[..., :2, :].reshape(*m.shape[:-2], 6)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    zeros = torch.zeros_like(v[..., 0])
    rows = torch.stack(
        [zeros, -v[..., 2], v[..., 1],
         v[..., 2], zeros, -v[..., 0],
         -v[..., 1], v[..., 0], zeros],
        dim=-1,
    )
    return rows.reshape(*v.shape[:-1], 3, 3)


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) axis-angle -> (..., 3, 3).

    Differentiable at theta = 0: the double `where` on the squared norm
    keeps the sqrt out of the gradient path there, which is where pose
    alignment starts.
    """
    sq = torch.sum(theta**2, dim=-1, keepdim=True)[..., None]
    small = sq < 1e-10
    one = torch.ones_like(sq)
    safe_sq = torch.where(small, one, sq)
    angle = torch.sqrt(safe_sq)
    w = skew(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device).expand(w.shape)
    a = torch.where(small, one, torch.sin(angle) / angle)
    b = torch.where(small, 0.5 * one, (1 - torch.cos(angle)) / safe_sq)
    return eye + a * w + b * (w @ w)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, theta] -> (..., 4, 4) SE3 matrix (differentiable at 0)."""
    rho, theta = tau[..., :3], tau[..., 3:]
    sq = torch.sum(theta**2, dim=-1, keepdim=True)[..., None]
    small = sq < 1e-10
    one = torch.ones_like(sq)
    safe_sq = torch.where(small, one, sq)
    angle = torch.sqrt(safe_sq)
    w = skew(theta)
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device).expand(w.shape)
    b = torch.where(small, 0.5 * one, (1 - torch.cos(angle)) / safe_sq)
    c = torch.where(small, one / 6.0,
                    (angle - torch.sin(angle)) / (safe_sq * angle))
    v = eye + b * w + c * (w @ w)
    t = (v @ rho[..., None])[..., 0]
    return pack_rt(so3_exp(theta), t)


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


def relative_pose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 @ b for c2w poses."""
    return inverse_se3(a) @ b


def pose_encoding_to_matrix(enc: torch.Tensor) -> torch.Tensor:
    """9D pose encoding [6D rot | 3D t] -> (..., 4, 4) c2w."""
    return pack_rt(rotation_6d_to_matrix(enc[..., :6]), enc[..., 6:9])


def camera_normalization(pivot: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Re-express `poses` so that `pivot` becomes identity."""
    return inverse_se3(pivot) @ poses


def project_to_cam(pts3d: torch.Tensor, c2w: torch.Tensor,
                   intrinsics: torch.Tensor) -> torch.Tensor:
    """World points (..., n, 3) into a camera with PIXEL intrinsics
    (..., 3, 3): pixel coordinates (..., n, 2), z clamped at 1e-6."""
    w2c = inverse_se3(c2w)
    cam = (
        torch.einsum("...ij,...nj->...ni", w2c[..., :3, :3], pts3d)
        + w2c[..., None, :3, 3]
    )
    px = torch.einsum("...ij,...nj->...ni", intrinsics, cam)
    z = torch.clamp(px[..., 2:3], min=1e-6)
    return px[..., :2] / z


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
