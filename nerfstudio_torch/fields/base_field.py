"""Field base API (counterpart of ``nerfstudio_tpu/fields/base_field.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nerfstudio_torch.core.rays import Frustums, RaySamples
from nerfstudio_torch.field_components.field_heads import FieldHeadNames


def get_normalized_directions(directions: torch.Tensor) -> torch.Tensor:
    """SH encodings expect directions in [0,1] (reference base_field.py:21-23)."""
    return (directions + 1.0) / 2.0


class Field(nn.Module):
    """Base field (reference base_field.py:26-86): RaySamples -> outputs."""

    def get_density(self, ray_samples: RaySamples) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (density (..., 1), geo_features (..., G))"""
        raise NotImplementedError

    def get_outputs(
        self, ray_samples: RaySamples, density_embedding: Optional[torch.Tensor] = None
    ) -> Dict[FieldHeadNames, torch.Tensor]:
        raise NotImplementedError

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        """Density at raw positions, the proposal sampler's hook: point-like
        samples at ``positions``."""
        zeros = torch.zeros_like(positions[..., :1])
        frustums = Frustums(
            origins=positions,
            directions=torch.tensor([0.0, 0.0, 1.0], device=positions.device).expand(positions.shape),
            starts=zeros,
            ends=zeros,
            pixel_area=torch.ones_like(zeros),
        )
        density, _ = self.get_density(RaySamples(frustums=frustums))
        return density

    def forward(
        self, ray_samples: RaySamples, compute_normals: bool = False, **density_kwargs
    ) -> Dict[FieldHeadNames, torch.Tensor]:
        """Density and heads (reference base_field.py:54-86). ``density_kwargs``
        go to ``get_density`` (nerfacto's ``bwd_levels`` gate). Normals from
        the density gradient are not ported."""
        if compute_normals:
            raise NotImplementedError("density-gradient normals are not ported")
        density, density_embedding = self.get_density(ray_samples, **density_kwargs)
        field_outputs = self.get_outputs(ray_samples, density_embedding=density_embedding)
        field_outputs[FieldHeadNames.DENSITY] = density
        return field_outputs
