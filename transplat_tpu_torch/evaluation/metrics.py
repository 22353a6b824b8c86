"""Image quality metrics (PSNR / SSIM).

Counterpart of transplat_tpu/evaluation/metrics.py: PSNR on [0, 1]-clipped
images; SSIM with skimage's conventions (Gaussian weights sigma 1.5, window
11, valid mode, data range 1, per channel then averaged). LPIPS lives in
loss/vgg.py.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(..., h, w, c) images in [0, 1] -> (...,) PSNR in dB."""
    gt = torch.clamp(ground_truth, 0.0, 1.0)
    pred = torch.clamp(predicted, 0.0, 1.0)
    mse = torch.mean((gt - pred) ** 2, dim=(-3, -2, -1))
    return -10.0 * torch.log10(mse + 1e-12)


def _gaussian_kernel(win: int = 11, sigma: float = 1.5) -> np.ndarray:
    r = np.arange(win) - (win - 1) / 2.0
    k = np.exp(-0.5 * (r / sigma) ** 2)
    k /= k.sum()
    return np.outer(k, k)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D correlation over (N, H, W)."""
    return F.conv2d(x[:, None], kernel[None, None])[:, 0]


def compute_ssim(
    ground_truth: torch.Tensor,
    predicted: torch.Tensor,
    data_range: float = 1.0,
    win: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """(N, h, w, c) images -> (N,) mean SSIM (skimage gaussian_weights=True)."""
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kernel = torch.as_tensor(_gaussian_kernel(win, sigma), dtype=ground_truth.dtype, device=ground_truth.device)

    n, h, w, c = ground_truth.shape
    x = ground_truth.movedim(-1, 1).reshape(n * c, h, w)
    y = predicted.movedim(-1, 1).reshape(n * c, h, w)

    mu_x = _filter2d(x, kernel)
    mu_y = _filter2d(y, kernel)
    mu_xx = _filter2d(x * x, kernel)
    mu_yy = _filter2d(y * y, kernel)
    mu_xy = _filter2d(x * y, kernel)

    # skimage's covariance normalisation is 1 with Gaussian weights.
    var_x = mu_xx - mu_x**2
    var_y = mu_yy - mu_y**2
    cov = mu_xy - mu_x * mu_y

    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / ((mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2))
    return ssim_map.reshape(n, c, *ssim_map.shape[1:]).mean(dim=(1, 2, 3))
