"""Shaders (counterpart of ``nerfstudio_tpu/model_components/shaders.py``)."""

from __future__ import annotations

import torch


def lambertian_shader(
    rgb: torch.Tensor,
    normals: torch.Tensor,
    light_direction: torch.Tensor,
    shading_weight: float = 1.0,
    detach_normals: bool = True,
) -> torch.Tensor:
    """rgb * ((1 - w) + w * max(n . l, 0)), the normals' gradient stopped
    with ``detach_normals``."""
    if detach_normals:
        normals = normals.detach()
    lambertian = torch.clamp_min(torch.sum(normals * light_direction, dim=-1, keepdim=True), 0.0)
    shading = (1.0 - shading_weight) + shading_weight * lambertian
    return rgb * shading


def normals_shader(normals: torch.Tensor) -> torch.Tensor:
    """Normals in [-1, 1] as colours in [0, 1]."""
    return (normals + 1.0) / 2.0
