"""Image metrics (counterpart of ``nerfstudio_tpu/utils/metrics.py``): PSNR
and SSIM. LPIPS is not ported (its weights are not in the repo)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """(reference :16-18)"""
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10) / max_val**2)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / torch.sum(g)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity of (H, W, C) images in [0, max_val] (reference
    :51-82): a separable Gaussian filter with zero padding, rows then
    columns. The convolutions run in full float32 (TF32 off whatever the
    global setting): with low-precision operands the variance terms
    mu_pp - mu_p^2 cancel catastrophically."""
    kernel = _gaussian_kernel(filter_size, filter_sigma, pred.device)
    pad = filter_size // 2
    c = pred.shape[-1]
    # the five filtered maps in one batch of 5C single-channel images
    stack = torch.cat([pred, target, pred * pred, target * target, pred * target], dim=-1)
    x = stack.permute(2, 0, 1)[:, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = F.conv2d(x, kernel.view(1, 1, -1, 1), padding=(pad, 0))
        x = F.conv2d(x, kernel.view(1, 1, 1, -1), padding=(0, pad))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    mu_p, mu_t, mu_pp, mu_tt, mu_pt = x[:, 0].permute(1, 2, 0).split(c, dim=-1)
    sigma_p = torch.clamp_min(mu_pp - mu_p**2, 0.0)
    sigma_t = torch.clamp_min(mu_tt - mu_t**2, 0.0)
    sigma_pt = mu_pt - mu_p * mu_t
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * sigma_pt + c2)) / ((mu_p**2 + mu_t**2 + c1) * (sigma_p + sigma_t + c2))
    return torch.mean(ssim_map)
