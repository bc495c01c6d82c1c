"""Photometric MSE loss (torch port of `spfsplatv2_tpu/losses/mse.py`)."""

from __future__ import annotations

import torch


def mse_loss(prediction: torch.Tensor, target: torch.Tensor,
             weight: float = 1.0, global_step: int | None = None,
             apply_after_step: int = 0) -> torch.Tensor:
    """Mean squared color error, gated by `apply_after_step`."""
    loss = weight * torch.mean((prediction - target) ** 2)
    if apply_after_step > 0 and global_step is not None \
            and global_step < apply_after_step:
        return torch.zeros_like(loss)
    return loss
