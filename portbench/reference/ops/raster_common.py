"""Projection stage of the Gaussian rasterizer (torch port).

Counterpart of `spfsplatv2_tpu/ops/raster_common.py`: EWA splatting of 3D
Gaussians to screen-space 2D Gaussians with the 3DGS CUDA preprocess
conventions:
  * near-plane cull at z <= 0.2
  * EWA Jacobian with t.x/t.z clamped to 1.3 * tan(fov/2)
  * +0.3 px low-pass added to the 2D covariance diagonal
  * radius = ceil(3 * sqrt(lambda_max)); rx, ry per-axis 3-sigma extents
  * pixel sample points at integer coordinates
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.geometry.se3 import inverse_se3
from portbench.reference.ops.sh import eval_sh_colors

NEAR_CULL = 0.2          # 3DGS near-plane cull threshold
LOWPASS = 0.3            # screen-space low-pass filter added to cov2d diag
ALPHA_MAX = 0.99         # per-gaussian alpha clamp
ALPHA_MIN = 1.0 / 255.0  # skip threshold
T_EPS = 1e-4             # transmittance early-stop threshold


class ProjectedGaussians(NamedTuple):
    """Screen-space 2D Gaussians for ONE camera.

    xy (g, 2) pixel coords; conic (g, 3) inverse 2D covariance (a, b, c);
    depth (g,) camera z (inf when culled); color (g, 3); opacity (g,);
    radius, rx, ry (g,) int32 (0 => culled).
    """

    xy: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor
    radius: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor


def project_gaussians(
    means: torch.Tensor,        # (g, 3)
    covariances: torch.Tensor,  # (g, 3, 3)
    harmonics: torch.Tensor,    # (g, 3, d_sh)
    opacities: torch.Tensor,    # (g,)
    c2w: torch.Tensor,          # (4, 4)
    intrinsics: torch.Tensor,   # (3, 3) normalized
    image_shape: tuple[int, int],
    sh_degree: int | None = None,
    use_sh: bool = True,
    ewa_reference_shape: tuple[int, int] | None = None,
) -> ProjectedGaussians:
    """Project one camera's view of a set of world-space Gaussians.

    `ewa_reference_shape`: the image whose frustum bounds the EWA clamp; a
    band of rows of a larger image (`parallel/raster_shard.py`) passes
    the full image's shape so that its conics match the full render's."""
    h, w = image_shape
    dtype = means.dtype

    w2c = inverse_se3(c2w)
    rot = w2c[:3, :3]
    t_cam = torch.einsum("ij,gj->gi", rot, means) + w2c[:3, 3]
    tz = t_cam[..., 2]
    valid = tz > NEAR_CULL
    tz_safe = torch.where(valid, tz, torch.ones_like(tz))

    fx = intrinsics[0, 0] * w
    fy = intrinsics[1, 1] * h
    cx = intrinsics[0, 2] * w - 0.5
    cy = intrinsics[1, 2] * h - 0.5

    px = fx * t_cam[..., 0] / tz_safe + cx
    py = fy * t_cam[..., 1] / tz_safe + cy
    xy = torch.stack([px, py], dim=-1)

    h_ref, w_ref = ewa_reference_shape or (h, w)
    tan_fx = 0.5 * w_ref / fx
    tan_fy = 0.5 * h_ref / fy
    lim_x = 1.3 * tan_fx
    lim_y = 1.3 * tan_fy
    txz = torch.clamp(t_cam[..., 0] / tz_safe, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(t_cam[..., 1] / tz_safe, -lim_y, lim_y) * tz_safe

    # cov2d = A Sigma A^T with A = J @ R, hand-expanded over flat (g,) arrays
    # in the JAX function's order of operations.
    u0 = fx / tz_safe
    u1 = fy / tz_safe
    w0 = fx * txz / (tz_safe * tz_safe)
    w1 = fy * tyz / (tz_safe * tz_safe)
    a_row0 = [u0 * rot[0, k] - w0 * rot[2, k] for k in range(3)]
    a_row1 = [u1 * rot[1, k] - w1 * rot[2, k] for k in range(3)]
    s = [[covariances[..., l, k] for k in range(3)] for l in range(3)]
    t0 = [sum(a_row0[l] * s[l][k] for l in range(3)) for k in range(3)]
    t1 = [sum(a_row1[l] * s[l][k] for l in range(3)) for k in range(3)]
    a = sum(t0[k] * a_row0[k] for k in range(3)) + LOWPASS
    b = sum(t0[k] * a_row1[k] for k in range(3))
    c = sum(t1[k] * a_row1[k] for k in range(3)) + LOWPASS

    det = a * c - b * b
    det_valid = det > 0
    det_safe = torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    valid = valid & det_valid & (radius > 0)
    zero = torch.zeros_like(radius)
    radius = torch.where(valid, radius, zero).to(torch.int32)
    rx = torch.where(valid, torch.ceil(3.0 * torch.sqrt(a)), zero).to(torch.int32)
    ry = torch.where(valid, torch.ceil(3.0 * torch.sqrt(c)), zero).to(torch.int32)

    if use_sh:
        campos = c2w[:3, 3]
        view_dir = means - campos
        view_dir = view_dir / (
            torch.linalg.norm(view_dir, dim=-1, keepdim=True) + 1e-12
        )
        color = eval_sh_colors(harmonics, view_dir, degree=sh_degree)
    else:
        color = harmonics[..., 0]

    depth = torch.where(valid, tz, torch.full_like(tz, float("inf"))).to(dtype)
    return ProjectedGaussians(
        xy=xy, conic=conic, depth=depth, color=color, opacity=opacities,
        radius=radius, rx=rx, ry=ry,
    )


def alpha_from_conic(
    xy: torch.Tensor,       # (..., g, 2)
    conic: torch.Tensor,    # (..., g, 3)
    opacity: torch.Tensor,  # (..., g)
    pix: torch.Tensor,      # (..., p, 2)
) -> torch.Tensor:
    """Per-pixel alphas (..., p, g) with the power > 0 skip, the 0.99
    clamp and the 1/255 cutoff."""
    d = pix[..., :, None, :] - xy[..., None, :, :]
    dx, dy = d[..., 0], d[..., 1]
    power = (
        -0.5 * (conic[..., None, :, 0] * dx * dx
                + conic[..., None, :, 2] * dy * dy)
        - conic[..., None, :, 1] * dx * dy
    )
    alpha = torch.clamp(opacity[..., None, :] * torch.exp(power), max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(keep, alpha, torch.zeros_like(alpha))
