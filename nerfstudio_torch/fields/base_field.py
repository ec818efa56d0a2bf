"""Field base API (counterpart of ``nerfstudio_tpu/fields/base_field.py``)."""

from __future__ import annotations

import dataclasses
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
        """Density and heads (reference base_field.py:54-90). ``density_kwargs``
        go to ``get_density`` (nerfacto's ``bwd_levels`` gate). With
        ``compute_normals`` the same forward gives the density, the
        embedding and the normals ``-grad sigma / max(|grad sigma|, 1e-10)``
        (``density_normals``)."""
        if compute_normals:
            density, density_embedding, normals = self.density_normals(ray_samples, **density_kwargs)
        else:
            density, density_embedding = self.get_density(ray_samples, **density_kwargs)
        field_outputs = self.get_outputs(ray_samples, density_embedding=density_embedding)
        field_outputs[FieldHeadNames.DENSITY] = density
        if compute_normals:
            field_outputs[FieldHeadNames.NORMALS] = normals
        return field_outputs

    def density_normals(self, ray_samples: RaySamples, **density_kwargs):
        """(density, embedding, normals) from one forward at point-like samples
        on the sample positions, the density differentiated in the positions
        as the reference's ``jax.grad(density_of)`` does. The positions keep
        their graph (camera-opt's pose adjustment reaches the normals through
        them), and so does the gradient when the caller records one
        (training: the normals' losses differentiate it again). Under
        ``no_grad`` (``render_camera``) the gradient is taken locally, in the
        positions alone, and nothing keeps a graph."""
        keep_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            positions = ray_samples.frustums.get_positions()
            if not positions.requires_grad:
                positions = positions.detach().requires_grad_(True)
            zeros = torch.zeros_like(positions[..., :1])
            frustums = dataclasses.replace(ray_samples.frustums, origins=positions, starts=zeros, ends=zeros)
            density, embedding = self.get_density(dataclasses.replace(ray_samples, frustums=frustums),
                                                  **density_kwargs)
            (grads,) = torch.autograd.grad(density.sum(), positions, create_graph=keep_graph)
        if not keep_graph:
            density, embedding = density.detach(), embedding.detach()
        normals = -grads / torch.clamp_min(torch.linalg.norm(grads, dim=-1, keepdim=True), 1e-10)
        return density, embedding, normals
