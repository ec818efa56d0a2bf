"""Grid interpolation, K8 (counterpart of ``nerfstudio_tpu/ops/interp.py``).

Plain PyTorch with autograd: the reference writes these in plain ``jnp``
(one gather per corner, no Pallas kernel, no custom VJP), so the port
keeps them as twins and has no hand-written kernel for them.

Conventions as the reference: coords in [-1, 1], align_corners=False. The
lower edge is not ``F.grid_sample``'s border padding: the upper corner
index is clamped from the already clamped lower one and the weight is not,
so at x = -1 on a 1..8 ramp the reference (and this port) give 1.5 where
``padding_mode="border"`` gives 1.0. ``resize_linear`` is
``jax.image.resize(..., "linear")``: half-pixel centres, a triangle filter
widened when downsampling, weights renormalised at the edges."""

from __future__ import annotations

from typing import Sequence

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coords, align_corners=False (reference :18-20)."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _corners(x: torch.Tensor, size: int):
    """Lower and upper corner indices, clamped as the reference clamps them,
    and the unclamped weight of the upper one."""
    x0 = torch.floor(x)
    lo = torch.clamp(x0.to(torch.int32), 0, size - 1).long()
    hi = torch.clamp(lo + 1, 0, size - 1)
    return lo, hi, x - x0


def grid_sample_1d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Linear sample along one axis (reference :56-68). grid (C, L); coords
    (...,) in [-1, 1]. Returns (..., C)."""
    _, L = grid.shape
    x0i, x1i, w = _corners(_unnormalize(coords, L), L)
    g = grid.t()  # (L, C)
    w = w[..., None]
    return g[x0i] * (1 - w) + g[x1i] * w


def grid_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (reference :23-53). grid (C, H, W); coords (..., 2) as
    (x, y) in [-1, 1]. Returns (..., C)."""
    _, H, W = grid.shape
    x0i, x1i, wx = _corners(_unnormalize(coords[..., 0], W), W)
    y0i, y1i, wy = _corners(_unnormalize(coords[..., 1], H), H)
    g = grid.permute(1, 2, 0)  # (H, W, C)
    wx, wy = wx[..., None], wy[..., None]
    return (g[y0i, x0i] * (1 - wx) * (1 - wy) + g[y0i, x1i] * wx * (1 - wy)
            + g[y1i, x0i] * (1 - wx) * wy + g[y1i, x1i] * wx * wy)


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample (reference :71-109). grid (C, D, H, W); coords (..., 3)
    as (x, y, z) in [-1, 1], x indexing W, y H and z D. Returns (..., C)."""
    _, D, H, W = grid.shape
    x0i, x1i, wx = _corners(_unnormalize(coords[..., 0], W), W)
    y0i, y1i, wy = _corners(_unnormalize(coords[..., 1], H), H)
    z0i, z1i, wz = _corners(_unnormalize(coords[..., 2], D), D)
    g = grid.permute(1, 2, 3, 0)  # (D, H, W, C)
    wx, wy, wz = wx[..., None], wy[..., None], wz[..., None]
    c00 = g[z0i, y0i, x0i] * (1 - wx) + g[z0i, y0i, x1i] * wx
    c01 = g[z0i, y1i, x0i] * (1 - wx) + g[z0i, y1i, x1i] * wx
    c10 = g[z1i, y0i, x0i] * (1 - wx) + g[z1i, y0i, x1i] * wx
    c11 = g[z1i, y1i, x0i] * (1 - wx) + g[z1i, y1i, x1i] * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of jax.image.resize "linear" along
    one axis (jax's ``compute_weight_mat`` with antialiasing, translation 0):
    a triangle of width max(1 / scale, 1) at half-pixel centres, each column
    renormalised, none where the sample lies outside the input."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32, device=device)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = torch.clamp_min(1 - torch.abs(x), 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(grid: torch.Tensor, new_spatial: Sequence[int]) -> torch.Tensor:
    """Linear resample of a (C, *spatial) grid to (C, *new_spatial)
    (reference :112-119, ``jax.image.resize`` "linear"): one weight matrix
    per axis whose size changes, contracted in axis order."""
    new_spatial = tuple(int(s) for s in new_spatial)
    if len(new_spatial) != grid.ndim - 1:
        raise ValueError(f"grid {tuple(grid.shape)} has {grid.ndim - 1} spatial axes, got {new_spatial}")
    out = grid
    for axis, size in enumerate(new_spatial, start=1):
        if out.shape[axis] == size:
            continue
        w = _linear_weights(out.shape[axis], size, grid.device).to(grid.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])), -1, axis)
    return out
