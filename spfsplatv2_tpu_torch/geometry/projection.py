"""Camera projection and ray library (torch port of
`spfsplatv2_tpu/geometry/projection.py`; batched, differentiable).

Intrinsics are NORMALIZED (pixel coordinates divided by the image size)
unless stated otherwise; extrinsics are camera-to-world 4x4.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.geometry.se3 import inverse_se3


def homogenize_points(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def homogenize_vectors(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)


def transform_rigid(xyzw: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", transform, xyzw)


def transform_cam2world(xyzw: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    return transform_rigid(xyzw, c2w)


def transform_world2cam(xyzw: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    return transform_rigid(xyzw, inverse_se3(c2w))


def project(points: torch.Tensor, intrinsics: torch.Tensor, eps: float = 1e-8):
    """Camera-space points -> (normalized image xy, in-front-of-camera mask)."""
    z = points[..., -1:]
    z_safe = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    xy_h = torch.einsum("...ij,...j->...i", intrinsics, points / z_safe)
    return xy_h[..., :2], points[..., -1] > eps


def unproject(coordinates: torch.Tensor, z: torch.Tensor,
              intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalized image coords + depth -> camera-space points."""
    k_inv = torch.linalg.inv(intrinsics)
    rays = torch.einsum("...ij,...j->...i", k_inv,
                        homogenize_points(coordinates))
    return rays * z[..., None]


def get_world_rays(coordinates: torch.Tensor, extrinsics: torch.Tensor,
                   intrinsics: torch.Tensor):
    """Image coords -> (world origins, unit world directions)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]),
                           intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1,
                                                keepdim=True)
    directions = torch.einsum("...ij,...j->...i", extrinsics[..., :3, :3],
                              directions)
    origins = torch.broadcast_to(extrinsics[..., :3, 3], directions.shape)
    return origins, directions


def sample_image_grid(shape: tuple[int, int], dtype=torch.float32,
                      device=None):
    """Pixel-centre coordinates of an image: (coordinates (h, w, 2) xy in
    [0, 1], indices (h, w, 2) ij integers)."""
    h, w = shape
    row = torch.arange(h, device=device)
    col = torch.arange(w, device=device)
    indices = torch.stack(torch.meshgrid(row, col, indexing="ij"), dim=-1)
    y = (row.to(dtype) + 0.5) / h
    x = (col.to(dtype) + 0.5) / w
    coords = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return coords, indices


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 2) horizontal and vertical FOV (radians) from normalized
    intrinsics."""
    k_inv = torch.linalg.inv(intrinsics)

    def ray(v):
        vec = torch.einsum("...ij,j->...i", k_inv,
                           torch.tensor(v, dtype=intrinsics.dtype,
                                        device=intrinsics.device))
        return vec / torch.linalg.norm(vec, dim=-1, keepdim=True)

    left, right = ray([0.0, 0.5, 1.0]), ray([1.0, 0.5, 1.0])
    top, bottom = ray([0.5, 0.0, 1.0]), ray([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp(torch.sum(left * right, dim=-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp(torch.sum(top * bottom, dim=-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)


def unnormalize_intrinsics(intrinsics: torch.Tensor,
                           image_shape: tuple[int, int]) -> torch.Tensor:
    """Normalized -> pixel-unit intrinsics for (h, w) images."""
    h, w = image_shape
    row_scale = torch.tensor([w, h, 1], dtype=intrinsics.dtype,
                             device=intrinsics.device)[:, None]
    return intrinsics * row_scale


def normalize_intrinsics(intrinsics: torch.Tensor,
                         image_shape: tuple[int, int]) -> torch.Tensor:
    h, w = image_shape
    row_scale = torch.tensor([1.0 / w, 1.0 / h, 1.0], dtype=intrinsics.dtype,
                             device=intrinsics.device)[:, None]
    return intrinsics * row_scale


def intersect_rays(origins_a: torch.Tensor, directions_a: torch.Tensor,
                   origins_b: torch.Tensor, directions_b: torch.Tensor,
                   eps: float = 1e-10) -> torch.Tensor:
    """Least-squares intersection point of ray pairs (..., 3); parallel
    rays map to +inf."""
    da = directions_a / torch.linalg.norm(directions_a, dim=-1, keepdim=True)
    db = directions_b / torch.linalg.norm(directions_b, dim=-1, keepdim=True)
    parallel = torch.abs(torch.sum(da * db, dim=-1)) >= 1 - eps

    eye = torch.eye(3, dtype=da.dtype, device=da.device)
    pa = eye - da[..., :, None] * da[..., None, :]
    pb = eye - db[..., :, None] * db[..., None, :]
    rhs = (pa @ origins_a[..., None] + pb @ origins_b[..., None])[..., 0]
    sol = torch.linalg.solve(pa + pb + 1e-8 * eye, rhs[..., None])[..., 0]
    return torch.where(parallel[..., None], torch.full_like(sol, float("inf")),
                       sol)
