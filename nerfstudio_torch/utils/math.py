"""Math helpers (counterpart of the matching functions of
``nerfstudio_tpu/utils/math.py``): mip-NeRF's conical-frustum Gaussians and
``expected_sin``, the ray/AABB slab test, splatfacto's init, and ``clip``
with ``jnp.clip``'s gradient."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Gaussians:
    """Mean (..., 3) and covariance (..., 3, 3) (reference :20-27)."""

    mean: torch.Tensor
    cov: torch.Tensor


def compute_3d_gaussian(directions: torch.Tensor, means: torch.Tensor, dir_variance: torch.Tensor,
                        radius_variance: torch.Tensor) -> Gaussians:
    """A Gaussian along ``directions`` from its variance along the ray and
    across it (reference :30-43)."""
    dir_outer = directions[..., :, None] * directions[..., None, :]
    dir_mag_sq = torch.clamp_min(torch.sum(directions * directions, dim=-1, keepdim=True), 1e-10)
    eye = torch.eye(3, dtype=directions.dtype, device=directions.device)
    null_outer = eye - directions[..., :, None] * (directions / dir_mag_sq)[..., None, :]
    dir_cov = dir_variance[..., None, None] * dir_outer
    radius_cov = radius_variance[..., None, None] * null_outer
    return Gaussians(mean=means, cov=dir_cov + radius_cov)


def conical_frustum_to_gaussian(origins: torch.Tensor, directions: torch.Tensor, starts: torch.Tensor,
                                ends: torch.Tensor, radius: torch.Tensor) -> Gaussians:
    """mip-NeRF's Gaussian of a conical frustum (reference :46-58), in the
    reference's float32 order (squares and fourth powers as products)."""
    mu = (starts + ends) / 2.0
    hw = (ends - starts) / 2.0
    mu2, hw2 = mu * mu, hw * hw
    hw4 = hw2 * hw2
    denom = 3.0 * mu2 + hw2
    means = origins + directions * (mu + (2.0 * mu * hw2) / denom)
    dir_variance = hw2 / 3 - (4 / 15) * ((hw4 * (12 * mu2 - hw2)) / (denom * denom))
    radius_variance = (radius * radius) * (mu2 / 4 + (5 / 12) * hw2 - (4 / 15) * hw4 / denom)
    return compute_3d_gaussian(directions, means, dir_variance[..., 0], radius_variance[..., 0])


def expected_sin(x_means: torch.Tensor, x_vars: torch.Tensor) -> torch.Tensor:
    """E[sin(x)] for x ~ N(mean, var) (reference :61-63)."""
    return torch.exp(-0.5 * x_vars) * torch.sin(x_means)


def intersect_aabb(origins: torch.Tensor, directions: torch.Tensor, aabb: torch.Tensor, max_bound: float = 1e10,
                   invalid_value: float = 1e10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test of rays against a flat (6,) aabb (reference :66-89): (nears,
    fars) (...,), nears clipped to [0, max_bound]; a ray that misses gets
    ``invalid_value`` for both. A direction component under 1e-10 in
    magnitude is taken as 1e-10."""
    inv_d = 1.0 / torch.where(torch.abs(directions) < 1e-10, torch.full_like(directions, 1e-10), directions)
    t_min = (aabb[:3] - origins) * inv_d
    t_max = (aabb[3:] - origins) * inv_d
    t1 = torch.minimum(t_min, t_max)
    t2 = torch.maximum(t_min, t_max)
    nears = torch.clamp(torch.amax(t1, dim=-1), 0.0, max_bound)
    fars = torch.clamp_max(torch.amin(t2, dim=-1), max_bound)
    miss = nears > fars
    invalid = torch.full_like(nears, invalid_value)
    return torch.where(miss, invalid, nears), torch.where(miss, invalid, fars)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: a max/min pair, whose derivative is 1/2
    where ``x`` sits exactly on a bound (``torch.clamp`` passes 1 there). The
    bounds are filled on ``x``'s device (``new_tensor`` would copy them
    from the host and wait for the card)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def random_quat(n: int, generator: Optional[torch.Generator] = None, uniforms: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """Uniform random unit quaternions wxyz (reference :224-235). ``uniforms``
    (3, n) in [0, 1) hands the draws in; otherwise they come from
    ``generator``."""
    if uniforms is None:
        uniforms = torch.rand((3, n), generator=generator, device=device)
    u, v, w = uniforms
    return torch.stack(
        [
            torch.sqrt(1 - u) * torch.sin(2 * math.pi * v),
            torch.sqrt(1 - u) * torch.cos(2 * math.pi * v),
            torch.sqrt(u) * torch.sin(2 * math.pi * w),
            torch.sqrt(u) * torch.cos(2 * math.pi * w),
        ],
        dim=-1,
    )


def k_nearest_neighbors(points: torch.Tensor, k: int, block: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN distances (excluding the point itself) from a row-blocked
    distance matrix (reference :238-279): (distances (n, k), indices (n, k)).

    Candidates come from ``|r|^2 + |p|^2 - 2 r.p``; the winners' distances are
    then recomputed from the coordinates, because the identity loses ~1e-3
    absolute to float32 cancellation, which wrecks the log-scale init of
    near-duplicate points."""
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    dists, idxs = [], []
    for start in range(0, n, block):
        rows = points[start:start + block]
        d2 = torch.sum(rows * rows, dim=-1)[:, None] + sq[None, :] - 2.0 * (rows @ points.T)
        own = torch.arange(start, start + rows.shape[0], device=points.device)
        d2[torch.arange(rows.shape[0], device=points.device), own] = math.inf
        idx = torch.topk(d2, k, dim=-1, largest=False).indices
        exact = torch.sum((rows[:, None, :] - points[idx]) ** 2, dim=-1)
        dists.append(torch.sqrt(torch.clamp_min(exact, 0.0)))
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)
