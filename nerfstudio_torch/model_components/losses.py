"""Losses (counterpart of ``nerfstudio_tpu/model_components/losses.py``):
the rgb MSE and mip-NeRF 360's interlevel and distortion losses. The
reference's comparison-count searchsorted maps to ``torch.searchsorted``
with the same side, and its one-hot lane select to ``torch.gather``. The
depth, normal and other losses are not ported."""

from __future__ import annotations

from typing import List

import torch

from nerfstudio_torch.core.rays import RaySamples

EPS = 1.0e-7


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def outer(
    t0_starts: torch.Tensor,
    t0_ends: torch.Tensor,
    t1_starts: torch.Tensor,
    t1_ends: torch.Tensor,
    y1: torch.Tensor,
) -> torch.Tensor:
    """Outer measure of the histogram (t1, y1) over the intervals
    [t0_starts, t0_ends] (reference :41-58, mip-NeRF 360 sec. 3.3)."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    n = y1.shape[-1]
    idx_lo = torch.clamp(torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(), side="right") - 1, 0, n - 1)
    idx_hi = torch.clamp(torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous(), side="right"), 0, n - 1)
    return torch.gather(cy1[..., 1:], -1, idx_hi) - torch.gather(cy1[..., :-1], -1, idx_lo)


def lossfun_outer(t: torch.Tensor, w: torch.Tensor, t_env: torch.Tensor, w_env: torch.Tensor) -> torch.Tensor:
    """The proposal histogram must upper-bound the fine one (reference :61-67)."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return torch.clamp_min(w - w_outer, 0.0) ** 2 / (w + EPS)


def ray_samples_to_sdist(ray_samples: RaySamples) -> torch.Tensor:
    """Spacing-domain bin edges (..., S+1) (reference :70-74)."""
    starts = ray_samples.spacing_starts[..., 0]
    ends = ray_samples.spacing_ends[..., 0]
    return torch.cat([starts, ends[..., -1:]], dim=-1)


def interlevel_loss(weights_list: List[torch.Tensor], ray_samples_list: List[RaySamples]) -> torch.Tensor:
    """mip-NeRF 360 interlevel loss (reference :77-91): the last (field)
    histogram, detached, is the target each proposal level must bound."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1][..., 0].detach()
    loss = 0.0
    for rs, wl in zip(ray_samples_list[:-1], weights_list[:-1]):
        loss = loss + torch.mean(lossfun_outer(c, w, ray_samples_to_sdist(rs), wl[..., 0]))
    return loss


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 distortion: concentrate and shrink the histogram
    (reference :94-101), in the O(S^2) pairwise form."""
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(weights_list: List[torch.Tensor], ray_samples_list: List[RaySamples]) -> torch.Tensor:
    """(reference :104-109)"""
    c = ray_samples_to_sdist(ray_samples_list[-1])
    w = weights_list[-1][..., 0]
    return torch.mean(lossfun_distortion(c, w))
