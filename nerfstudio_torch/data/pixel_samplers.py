"""Pixel sampling on the device (counterpart of
``nerfstudio_tpu/data/pixel_samplers.py``): (camera, row, col) draws and one
gather from the device-resident image stack, with no host work per step.

The uniform, fisheye, equirectangular, patch and pair samplers, and the
masked sampler, which draws among a precomputed table of the mask-valid
pixels (``build_valid_indices``, the reference's stand-in for rejection
sampling). Each sampler draws from an explicit ``torch.Generator``, or
takes its random draws handed in (``draws``: the tensors the reference's
function draws, in its order), so that a test can feed it the JAX
package's draws."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def _randint(lo: int, hi: int, shape, generator, device) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=generator, device=device)


def _rand(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def sample_pixel_indices(
    num_rays: int,
    num_images: int,
    image_height: int,
    image_width: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Uniform (camera, row, col) indices: (num_rays, 3) int64
    (reference :60-73). ``draws``: (camera, row, col), each (num_rays,)."""
    if draws is None:
        draws = (_randint(0, num_images, (num_rays,), generator, device),
                 _randint(0, image_height, (num_rays,), generator, device),
                 _randint(0, image_width, (num_rays,), generator, device))
    return torch.stack([d.long() for d in draws], dim=-1)


def sample_pixel_indices_fisheye(
    num_rays: int,
    num_images: int,
    image_height: int,
    image_width: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Uniform in (radius, angle) about the image centre, so the rim is not
    oversampled against the fisheye's solid angle (reference :34-57).
    ``draws``: (camera, radius in [0, 1), angle in [0, 1)), each (num_rays,)."""
    if draws is None:
        draws = (_randint(0, num_images, (num_rays,), generator, device), _rand((num_rays,), generator, device),
                 _rand((num_rays,), generator, device))
    c, u_radius, u_theta = draws
    radius = u_radius * (min(image_height, image_width) / 2.0)
    theta = u_theta * (2 * math.pi)
    row = torch.clamp((image_height / 2.0 + radius * torch.sin(theta)).to(torch.int32), 0, image_height - 1)
    col = torch.clamp((image_width / 2.0 + radius * torch.cos(theta)).to(torch.int32), 0, image_width - 1)
    return torch.stack([c.long(), row.long(), col.long()], dim=-1)


def sample_pixel_indices_equirectangular(
    num_rays: int,
    num_images: int,
    image_height: int,
    image_width: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Rows at acos(1 - 2u), uniform in solid angle (reference :76-91).
    ``draws``: (camera, u in [0, 1), col), each (num_rays,)."""
    if draws is None:
        draws = (_randint(0, num_images, (num_rays,), generator, device), _rand((num_rays,), generator, device),
                 _randint(0, image_width, (num_rays,), generator, device))
    c, u, w = draws
    r = torch.clamp((torch.arccos(1.0 - 2.0 * u) / math.pi * image_height).to(torch.int32), 0, image_height - 1)
    return torch.stack([c.long(), r.long(), w.long()], dim=-1)


def sample_pixel_indices_from_valid(
    num_rays: int,
    valid_indices: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Rows drawn uniformly from the (M, 3) table of mask-valid (camera,
    row, col) (reference :94-100). ``draws``: (pick,), (num_rays,) in [0, M)."""
    if draws is None:
        draws = (_randint(0, valid_indices.shape[0], (num_rays,), generator, valid_indices.device),)
    return valid_indices[draws[0].long()].long()


def sample_patch_pixel_indices(
    num_rays: int,
    patch_size: int,
    num_images: int,
    image_height: int,
    image_width: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """num_rays // patch_size^2 square patches, each flattened row-major
    (reference :103-124). ``draws``: (camera, top row, left col), each one
    per patch."""
    n_patches = num_rays // (patch_size**2)
    if draws is None:
        draws = (_randint(0, num_images, (n_patches,), generator, device),
                 _randint(0, image_height - patch_size + 1, (n_patches,), generator, device),
                 _randint(0, image_width - patch_size + 1, (n_patches,), generator, device))
    c, r0, w0 = (d.long() for d in draws)
    dr = torch.arange(patch_size, device=c.device)
    grid_r, grid_w = torch.meshgrid(dr, dr, indexing="ij")
    r = (r0[:, None, None] + grid_r[None]).reshape(-1)
    w = (w0[:, None, None] + grid_w[None]).reshape(-1)
    return torch.stack([torch.repeat_interleave(c, patch_size**2), r, w], dim=-1)


def sample_pair_pixel_indices(
    num_rays: int,
    num_images: int,
    image_height: int,
    image_width: int,
    radius: int = 2,
    generator: Optional[torch.Generator] = None,
    device=None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """num_rays // 2 pairs of nearby pixels, each pair on consecutive rows
    (reference :127-146). ``draws``: (camera, row, col), one per pair, and
    the (pairs, 2) offsets in [-radius, radius]."""
    n_pairs = num_rays // 2
    if draws is None:
        draws = (_randint(0, num_images, (n_pairs,), generator, device),
                 _randint(radius, image_height - radius, (n_pairs,), generator, device),
                 _randint(radius, image_width - radius, (n_pairs,), generator, device),
                 _randint(-radius, radius + 1, (n_pairs, 2), generator, device))
    c, r, w, offs = (d.long() for d in draws)
    first = torch.stack([c, r, w], dim=-1)
    second = torch.stack([c, r + offs[:, 0], w + offs[:, 1]], dim=-1)
    return torch.stack([first, second], dim=1).reshape(-1, 3)


_UNIT = {}  # device -> the 256 values of uint8 / 255 in float32


def _unit_table(device: torch.device) -> torch.Tensor:
    """uint8 / 255 as a table computed once on the CPU: a CUDA division by
    a scalar multiplies by its reciprocal, 1 ulp off the true quotient for
    some values, so the card looks the quotients up instead and gathers the
    CPU's (and the reference's) values."""
    if device not in _UNIT:
        _UNIT[device] = (torch.arange(256, dtype=torch.float32) / 255.0).to(device)
    return _UNIT[device]


def gather_pixels(images: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Values at (camera, row, col): images (N, H, W, C) uint8 or float32 ->
    (num_rays, C) float32, uint8 scaled to [0, 1] (reference :149-155)."""
    vals = images[indices[:, 0], indices[:, 1], indices[:, 2]]
    if vals.dtype == torch.uint8:
        vals = _unit_table(vals.device)[vals.long()]
    return vals


def build_valid_indices(masks: np.ndarray) -> np.ndarray:
    """On the host: (N, H, W, 1) bool masks -> (M, 3) int32 rows (camera,
    row, col) of the valid pixels, in row-major order (reference :158-161)."""
    return np.argwhere(masks[..., 0]).astype(np.int32)
