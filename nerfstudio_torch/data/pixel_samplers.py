"""Pixel sampling on the device (counterpart of
``nerfstudio_tpu/data/pixel_samplers.py``): uniform (camera, row, col)
draws and one gather from the device-resident image stack. The bucketed,
masked, patch, pair, fisheye and equirectangular samplers are not ported."""

from __future__ import annotations

from typing import Optional

import torch


def sample_pixel_indices(
    num_rays: int,
    num_images: int,
    image_height: int,
    image_width: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Uniform (camera, row, col) indices: (num_rays, 3) int64
    (reference :60-73)."""
    kw = dict(generator=generator, device=device)
    return torch.stack(
        [
            torch.randint(0, num_images, (num_rays,), **kw),
            torch.randint(0, image_height, (num_rays,), **kw),
            torch.randint(0, image_width, (num_rays,), **kw),
        ],
        dim=-1,
    )


def gather_pixels(images: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Values at (camera, row, col): images (N, H, W, C) uint8 or float32 ->
    (num_rays, C) float32, uint8 scaled to [0, 1] (reference :149-155)."""
    vals = images[indices[:, 0], indices[:, 1], indices[:, 2]]
    if vals.dtype == torch.uint8:
        vals = vals.to(torch.float32) / 255.0
    return vals
