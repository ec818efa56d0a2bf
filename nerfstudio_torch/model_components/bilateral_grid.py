"""Bilateral grid for per-image exposure and colour correction (counterpart
of ``nerfstudio_tpu/model_components/bilateral_grid.py``).

One learnable low-resolution grid per training image holds a 3x4 affine
colour transform in each cell over (x, y, luma). Slicing samples the 12
coefficients trilinearly (``ops.interp.grid_sample_3d``, K8) at each pixel's
(x, y, luma(rgb)) and applies them; the luma guidance is differentiated
too, so rgb gets a gradient through the sample weights as well as through
the affine product. ``color_correct`` is the post-hoc fit used for fair
eval metrics."""

from __future__ import annotations

from typing import Optional

import torch

from nerfstudio_torch.ops.interp import grid_sample_3d
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.math import clip

# Rec. 709 luma, the guidance channel (reference :24)
LUMA = (0.2126, 0.7152, 0.0722)


def init_bilateral_grid(num_images: int, grid_x: int = 16, grid_y: int = 16, grid_w: int = 8,
                        device=None) -> torch.Tensor:
    """(num_images, 12, grid_w, grid_y, grid_x) grids, each cell the
    identity transform [I | 0] (reference :27-34), on ``device`` (CUDA by
    default)."""
    ident = torch.zeros((12,), dtype=torch.float32, device=resolve_device(device))
    ident[0] = ident[5] = ident[10] = 1.0
    return ident.view(1, 12, 1, 1, 1).repeat(num_images, 1, grid_w, grid_y, grid_x)


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    """rgb @ LUMA as three products and two sums, so every device rounds
    alike (the weights as float32 scalars: no copy to the device)."""
    return rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1] + rgb[..., 2] * LUMA[2]


def slice_bilateral_grid(grid: torch.Tensor, rgb: torch.Tensor, xy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One image's grid (12, W, Y, X) applied to rgb (H, W, 3) in [0, 1]
    (reference :37-60); ``xy`` (H, W, 2) in [0, 1], the pixel centres by
    default. Returns the corrected (H, W, 3)."""
    h, w, _ = rgb.shape
    if xy is None:
        ys = (torch.arange(h, dtype=torch.float32, device=rgb.device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=rgb.device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        xy = torch.stack([xx, yy], dim=-1)
    luma = clip(_luma(rgb), 0.0, 1.0)
    coords = torch.stack([xy[..., 0] * 2 - 1, xy[..., 1] * 2 - 1, luma * 2 - 1], dim=-1)
    A = grid_sample_3d(grid, coords).view(h, w, 3, 4)
    return (A[..., 0] * rgb[..., None, 0] + A[..., 1] * rgb[..., None, 1] + A[..., 2] * rgb[..., None, 2]
            + A[..., 3])


def bilateral_grid_tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Total variation over the grids' three spatial axes (reference :63-69)."""
    tv = grids.new_zeros(())
    for axis in (-3, -2, -1):
        tv = tv + torch.mean(torch.diff(grids, dim=axis) ** 2)
    return tv


def color_correct(img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Post-hoc per-channel quadratic colour fit of ``img`` to ``ref``
    (reference :72-91): the ridge normal equations over the features [r, g,
    b, rg, rb, gb, r^2, g^2, b^2, 1], one 10x10 ``torch.linalg.solve`` per
    channel, the fit clipped to [0, 1]. The normal equations sum every
    pixel and the solve amplifies their roundings, so they are summed and
    solved in float64: in float32 the fit moved with the BLAS's order of
    summation (at 200^2, 3e-4 off a float64 fit on one CPU thread, 1e-5 on
    eight; the reference's XLA sum 3e-5). The fit is evaluated in the
    image's dtype."""
    img_f = img.reshape(-1, 3)
    ref_f = ref.reshape(-1, 3)
    r, g, b = img_f.unbind(-1)
    A = torch.stack([r, g, b, r * g, r * b, g * b, r * r, g * g, b * b, torch.ones_like(r)], dim=-1)
    A64 = A.double()
    AtA = A64.t() @ A64 + 1e-4 * torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    out = []
    for c in range(3):
        w = torch.linalg.solve(AtA, A64.t() @ ref_f[:, c].double())
        out.append(clip(A @ w.to(A.dtype), 0.0, 1.0))
    return torch.stack(out, dim=-1).reshape(img.shape)
