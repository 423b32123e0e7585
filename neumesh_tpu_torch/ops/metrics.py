"""Image quality metrics (counterpart of neumesh_tpu/ops/metrics.py):
MSE and PSNR with an optional valid mask, and SSIM with a Gaussian
window (sigma 1.5, kornia's choice), 'valid' padding."""
from __future__ import annotations

import torch


def mse(image_pred, image_gt, valid_mask=None, reduction="mean"):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = torch.where(valid_mask, value, torch.zeros_like(value))
        if reduction == "mean":
            n = torch.sum(valid_mask) * (value.numel() // valid_mask.numel())
            return torch.sum(value) / torch.clamp(n, min=1)
        return value
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr(image_pred, image_gt, valid_mask=None, reduction="mean"):
    """-10 log10(mse)."""
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask,
                                   reduction))


def gaussian_kernel1d(win: int, sigma: float, device=None):
    """Normalised 1-D Gaussian taps."""
    x = torch.arange(win, dtype=torch.float32, device=device) \
        - (win - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _window_filter_valid(x, kernel):
    """Separable filter with 1-D taps over the last two dims of (C, H, W),
    'valid' padding."""
    win = kernel.shape[0]
    h_out = x.shape[1] - win + 1
    x = sum(kernel[i] * x[:, i:i + h_out, :] for i in range(win))
    w_out = x.shape[2] - win + 1
    return sum(kernel[i] * x[:, :, i:i + w_out] for i in range(win))


def ssim(image_pred, image_gt, win: int = 3, max_val: float = 1.0,
         reduction: str = "mean", sigma: float = 1.5):
    """SSIM with a Gaussian window (sigma=None: a box window) on
    channel-first (C, H, W) images in [0, max_val]."""
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    if sigma is None:
        kernel = torch.full((win,), 1.0 / win, device=image_pred.device)
    else:
        kernel = gaussian_kernel1d(win, sigma, image_pred.device)

    def filt(x):
        return _window_filter_valid(x, kernel)

    mu_x, mu_y = filt(image_pred), filt(image_gt)
    mu_xx = filt(image_pred * image_pred)
    mu_yy = filt(image_gt * image_gt)
    mu_xy = filt(image_pred * image_gt)
    sigma_x = mu_xx - mu_x ** 2
    sigma_y = mu_yy - mu_y ** 2
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2)
    ssim_map = num / den
    return torch.mean(ssim_map) if reduction == "mean" else ssim_map
