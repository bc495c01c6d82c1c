"""Image and pose evaluation metrics (torch port of
`spfsplatv2_tpu/evaluation/metrics.py`): PSNR, SSIM, LPIPS, pose errors
(geodesic rotation angle and translation-direction angle) and their
AUC@{5, 10, 20} degrees summary."""

from __future__ import annotations

import numpy as np
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


def pose_auc(errors: np.ndarray, thresholds: list[float]) -> list[float]:
    """Area under the recall curve at error thresholds (host-side numpy;
    copy of `spfsplatv2_tpu/geometry/se3.py:pose_auc`)."""
    errors = np.sort(np.asarray(errors))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[max(last - 1, 0)]]
        e = np.r_[errors[:last], t]
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs


def pose_auc_summary(
    rot_errors_deg: np.ndarray,
    transl_errors_deg: np.ndarray,
    thresholds=(5.0, 10.0, 20.0),
) -> dict:
    """AUC at `thresholds` and the median of the rotation, translation
    and combined (the larger of the two) errors."""
    combined = np.maximum(rot_errors_deg, transl_errors_deg)
    out = {}
    for name, err in (
        ("rotation", rot_errors_deg),
        ("translation", transl_errors_deg),
        ("pose", combined),
    ):
        aucs = pose_auc(err, list(thresholds))
        out[f"{name}_auc"] = {
            f"@{int(t)}deg": a for t, a in zip(thresholds, aucs)
        }
        out[f"{name}_median_deg"] = float(np.median(err))
    return out
