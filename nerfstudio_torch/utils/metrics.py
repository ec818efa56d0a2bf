"""Image metrics (counterpart of ``nerfstudio_tpu/utils/metrics.py``):
PSNR. SSIM and LPIPS are not ported."""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """(reference :16-18)"""
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10) / max_val**2)
