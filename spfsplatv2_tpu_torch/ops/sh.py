"""Real spherical harmonics evaluation, degrees 0-4 (torch port).

Counterpart of `spfsplatv2_tpu/ops/sh.py`: 3D Gaussian Splatting basis
ordering and signs for degrees 0-3, the standard real-SH extension for
degree 4, and the `+0.5, clamp >= 0` colour convention.
"""

from __future__ import annotations

import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_basis(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis at unit `directions` (..., 3) -> (..., (degree+1)**2)."""
    if degree > 4:
        raise NotImplementedError(f"sh degree {degree} > 4")
    x, y, z = directions.unbind(-1)
    out = [torch.full_like(x, C0)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh_colors(
    harmonics: torch.Tensor, directions: torch.Tensor,
    degree: int | None = None,
) -> torch.Tensor:
    """SH coefficients (..., 3, d_sh) + view directions (..., 3) -> RGB (..., 3)."""
    d_sh = harmonics.shape[-1]
    if degree is None:
        degree = math.isqrt(d_sh) - 1
        if (degree + 1) ** 2 != d_sh:
            raise ValueError(
                f"harmonics last dim {d_sh} is not a perfect square; pass an "
                f"explicit sh degree"
            )
    basis = sh_basis(directions, degree)  # (..., n_b)
    n_b = basis.shape[-1]
    color = torch.sum(harmonics[..., :n_b] * basis[..., None, :], dim=-1)
    return torch.clamp(color + 0.5, min=0.0)
