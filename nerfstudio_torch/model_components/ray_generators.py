"""Ray generator: pixel indices -> RayBundle (counterpart of
``nerfstudio_tpu/model_components/ray_generators.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.core.rays import RayBundle


def generate_rays_from_indices(cameras: Cameras, ray_indices: torch.Tensor,
                               camera_opt_to_camera: Optional[torch.Tensor] = None,
                               pixel_offset: float = 0.5) -> RayBundle:
    """ray_indices: (N, 3) int (camera, row, col) -> N rays through the
    pixel centres, with ``camera_opt_to_camera`` (N, 3, 4) composed onto
    their cameras where given (reference :18-33). nerfacto applies its
    camera-opt to the bundle instead."""
    y = ray_indices[:, 1].to(torch.float32)
    x = ray_indices[:, 2].to(torch.float32)
    coords = torch.stack([y + pixel_offset, x + pixel_offset], dim=-1)
    return cameras.generate_rays_from_coords(ray_indices[:, 0:1], coords, camera_opt_to_camera)
