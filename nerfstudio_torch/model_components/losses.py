"""Losses (counterpart of ``nerfstudio_tpu/model_components/losses.py``):
the rgb MSE, mip-NeRF 360's interlevel and distortion losses, TensoRF's
total variation of its feature planes (``tv_loss``), and the depth
supervision of depth-nerfacto (DS-NeRF's likelihood and URF's
line-of-sight loss, ``depth_loss``), and Ref-NeRF's orientation and the
predicted-normal losses of nerfacto with ``predict_normals``. The
reference's comparison-count searchsorted maps to ``torch.searchsorted``
with the same side, and its one-hot lane select to ``torch.gather``. Not
ported: ``masked_l1``, the MonoSDF normal loss, the scale-
and shift-invariant depth loss, the depth ranking loss and
``scale_gradients_by_distance_squared``, which no ported method calls."""

from __future__ import annotations

import math
from typing import List, Literal

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
    loss = w.new_zeros(())  # 0 without a proposal level (occupancy-PDF sampling alone)
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



def orientation_loss(weights: torch.Tensor, normals: torch.Tensor, view_dirs: torch.Tensor) -> torch.Tensor:
    """Ref-NeRF's orientation loss: normals must not face away from the
    camera (reference losses.py:113-121). weights (..., S, 1), normals
    (..., S, 3), view_dirs (..., 3) -> (...,)."""
    n_dot_v = torch.sum(normals * -view_dirs[..., None, :], dim=-1)
    return torch.sum(weights[..., 0] * torch.clamp_max(n_dot_v, 0.0) ** 2, dim=-1)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor, pred_normals: torch.Tensor) -> torch.Tensor:
    """Predicted normals follow the density-gradient normals (reference
    losses.py:124-129): (...,)."""
    return torch.sum(weights[..., 0] * (1.0 - torch.sum(normals * pred_normals, dim=-1)), dim=-1)


def ds_nerf_depth_loss(weights: torch.Tensor, termination_depth: torch.Tensor, steps: torch.Tensor,
                       lengths: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """DS-NeRF's likelihood depth loss (reference :132-147): weights, steps
    and lengths (R, S, 1), termination depths (R, 1); rays of depth 0 are
    unsupervised. The Gaussian's denominator is 2 sigma, as the reference
    writes it."""
    depth_mask = (termination_depth > 0).to(weights.dtype)
    loss = -torch.log(weights + EPS) * torch.exp(-((steps - termination_depth[:, None]) ** 2) / (2 * sigma)) * lengths
    return torch.mean(torch.sum(loss, dim=-2) * depth_mask)


def urf_depth_loss(weights: torch.Tensor, termination_depth: torch.Tensor, predicted_depth: torch.Tensor,
                   steps: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Urban Radiance Fields' expected-depth and line-of-sight loss
    (reference :150-172), shapes as ``ds_nerf_depth_loss``'s and the
    predicted depth (R, 1)."""
    depth_mask = (termination_depth > 0).to(weights.dtype)
    expected_depth_loss = (termination_depth - predicted_depth) ** 2
    offset = steps - termination_depth[:, None]
    line_of_sight_obj_mask = (torch.abs(offset) < sigma).to(weights.dtype)
    target = torch.exp(-(offset**2) / (2 * sigma)) / torch.sqrt(2 * math.pi * sigma)
    line_of_sight_obj_loss = torch.sum(
        line_of_sight_obj_mask * (weights - target * (2 * sigma / steps.shape[-2])) ** 2, dim=-2)
    empty_mask = (steps < termination_depth[:, None] - sigma).to(weights.dtype)
    line_of_sight_empty_loss = torch.sum(empty_mask * weights**2, dim=-2)
    loss = expected_depth_loss + line_of_sight_obj_loss + line_of_sight_empty_loss
    return torch.mean(loss * depth_mask)


def depth_loss(weights: torch.Tensor, ray_samples: RaySamples, termination_depth: torch.Tensor,
               predicted_depth: torch.Tensor, sigma: torch.Tensor, directions_norm: torch.Tensor,
               is_euclidean: bool, depth_loss_type: Literal["ds_nerf", "urf"] = "ds_nerf") -> torch.Tensor:
    """The configured depth loss at the sample midpoints (reference
    :175-194). A z-depth (``is_euclidean`` false) becomes a distance along
    the ray through the ray's ``directions_norm``."""
    if not is_euclidean:
        termination_depth = termination_depth * directions_norm
    steps = (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2
    if depth_loss_type == "ds_nerf":
        lengths = ray_samples.frustums.ends - ray_samples.frustums.starts
        return ds_nerf_depth_loss(weights, termination_depth, steps, lengths, sigma)
    if depth_loss_type == "urf":
        return urf_depth_loss(weights, termination_depth, predicted_depth, steps, sigma)
    raise ValueError(depth_loss_type)


def tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Total variation of feature grids (..., C, H, W): the mean squared
    difference of neighbours along H plus along W (reference :236-240)."""
    h_tv = torch.mean((grids[..., 1:, :] - grids[..., :-1, :]) ** 2)
    w_tv = torch.mean((grids[..., :, 1:] - grids[..., :, :-1]) ** 2)
    return h_tv + w_tv
