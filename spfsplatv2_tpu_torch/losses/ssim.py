"""Gaussian-window SSIM (torch port of `spfsplatv2_tpu/losses/ssim.py`):
11x11 sigma-1.5 window, data_range 1, 'valid' filtering."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' convolution of NCHW `img` with a (k, k) kernel."""
    c = img.shape[1]
    return F.conv2d(img, kernel[None, None].expand(c, 1, *kernel.shape),
                    groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per batch element; a, b (batch, h, w, c) in [0, data_range]."""
    kernel = torch.as_tensor(_gaussian_kernel(size, sigma), device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a = a.permute(0, 3, 1, 2)
    b = b.permute(0, 3, 1, 2)
    mu_a = _filter2d(a, kernel)
    mu_b = _filter2d(b, kernel)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a = _filter2d(a * a, kernel) - mu_aa
    sigma_b = _filter2d(b * b, kernel) - mu_bb
    sigma_ab = _filter2d(a * b, kernel) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sigma_a + sigma_b + c2)
    return torch.mean(num / den, dim=(1, 2, 3))
