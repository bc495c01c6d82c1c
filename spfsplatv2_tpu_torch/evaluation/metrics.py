"""Image and pose evaluation metrics (torch port of
`spfsplatv2_tpu/evaluation/metrics.py`): PSNR, SSIM, LPIPS and pose
errors."""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.losses.ssim import ssim


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(batch, h, w, 3) in [0, 1] -> (batch,) PSNR in dB."""
    gt = torch.clamp(ground_truth, 0.0, 1.0)
    pred = torch.clamp(predicted, 0.0, 1.0)
    mse = torch.mean((gt - pred) ** 2, dim=(-3, -2, -1))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def compute_ssim(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    return ssim(torch.clamp(predicted, 0.0, 1.0),
                torch.clamp(ground_truth, 0.0, 1.0))


def compute_pose_error(predicted_c2w: torch.Tensor, gt_c2w: torch.Tensor):
    """(..., 4, 4) poses -> (rotation deg, translation-direction deg)."""
    rot = se3.rotation_angle_deg(predicted_c2w[..., :3, :3], gt_c2w[..., :3, :3])
    tr = se3.translation_angle_deg(predicted_c2w[..., :3, 3], gt_c2w[..., :3, 3])
    return rot, tr


def compute_lpips(lpips, ground_truth: torch.Tensor,
                  predicted: torch.Tensor) -> torch.Tensor:
    """(batch, h, w, 3) in [0, 1] -> (batch,) LPIPS of `lpips` (a
    `losses.lpips.LPIPS`)."""
    return lpips(torch.clamp(predicted, 0, 1) * 2 - 1,
                 torch.clamp(ground_truth, 0, 1) * 2 - 1)
