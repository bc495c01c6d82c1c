"""Regr3D pointmap distillation loss (torch port of
`spfsplatv2_tpu/losses/point.py`).

The DUSt3R teacher's pointmaps supervise the student's through an L2
norm after joint pointcloud normalization, over the points whose teacher
distance lies within each row's [0.2%, 99.8%] quantiles and whose
teacher confidence is at least 3.  Dense masks, as in JAX.
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.geometry.pointcloud import normalize_pointcloud


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _quantile_mask(dis: torch.Tensor, quantiles: tuple[float, float]):
    """Per batch row: lo <= dis <= hi at the row's quantiles (linear
    interpolation, `jnp.quantile`'s default).  `torch.quantile` takes at
    most 2^24 elements a call, so it runs row by row."""
    flat = dis.reshape(dis.shape[0], -1)
    q = torch.tensor(quantiles, dtype=dis.dtype, device=dis.device)
    bounds = torch.stack([torch.quantile(row, q, interpolation="linear")
                          for row in flat])               # (b, 2)
    lo = bounds[:, 0].reshape(-1, 1, 1)
    hi = bounds[:, 1].reshape(-1, 1, 1)
    return (dis >= lo) & (dis <= hi)


def regr3d_loss(
    gt_pts1: torch.Tensor,   # (b, h, w, 3) teacher points of view 0
    gt_pts2: torch.Tensor,   # of view 1, both in view 0's frame
    pr_pts1: torch.Tensor,   # the student's
    pr_pts2: torch.Tensor,
    conf1: torch.Tensor,     # (b, h, w) teacher confidence
    conf2: torch.Tensor,
    norm_mode: str = "avg_dis",
    conf_min: float = 3.0,
    quantiles: tuple[float, float] = (0.002, 0.998),
    disable_view1: bool = False,
) -> torch.Tensor:
    valid1 = (_quantile_mask(torch.linalg.norm(gt_pts1, dim=-1), quantiles)
              & (conf1 >= conf_min))
    valid2 = (_quantile_mask(torch.linalg.norm(gt_pts2, dim=-1), quantiles)
              & (conf2 >= conf_min))
    if norm_mode:
        pr_pts1, pr_pts2, _ = normalize_pointcloud(pr_pts1, pr_pts2, norm_mode,
                                                   valid1, valid2)
        gt_pts1, gt_pts2, _ = normalize_pointcloud(gt_pts1, gt_pts2, norm_mode,
                                                   valid1, valid2)
    total = _masked_mean(torch.linalg.norm(pr_pts2 - gt_pts2, dim=-1), valid2)
    if not disable_view1:
        total = total + _masked_mean(
            torch.linalg.norm(pr_pts1 - gt_pts1, dim=-1), valid1)
    return total
