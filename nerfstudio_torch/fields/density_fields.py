"""Proposal density field (counterpart of
``nerfstudio_tpu/fields/density_fields.py``): hash grid (block layout K1,
or the flat layout K7) + tiny MLP."""

from __future__ import annotations

from typing import Tuple

import torch

from nerfstudio_torch.core.rays import RaySamples
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.field_components.activations import trunc_exp
from nerfstudio_torch.field_components.mlp import MLPWithHashEncoding
from nerfstudio_torch.field_components.spatial_distortions import SceneContraction
from nerfstudio_torch.fields.base_field import Field
from nerfstudio_torch.utils.device import resolve_device


class HashMLPDensityField(Field):
    """(reference density_fields.py:21-78). ``block`` takes the block layout,
    whose stochastic K1 path the field keeps at eval as the reference does
    (proposal density only places samples); the default, as the
    reference's, is the flat layout (K7), neus-facto's."""

    def __init__(
        self,
        aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
            (-1.0, -1.0, -1.0),
            (1.0, 1.0, 1.0),
        ),
        num_layers: int = 2,
        hidden_dim: int = 16,
        use_spatial_distortion: bool = False,
        num_levels: int = 5,
        max_res: int = 128,
        base_res: int = 16,
        log2_hashmap_size: int = 17,
        features_per_level: int = 2,
        average_init_density: float = 1.0,
        block: bool = False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.aabb = aabb
        self.average_init_density = average_init_density
        self.mlp_base = MLPWithHashEncoding(
            num_levels=num_levels,
            min_res=base_res,
            max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level,
            num_layers=num_layers,
            layer_width=hidden_dim,
            out_dim=1,
            block=block,
            device=device,
        )
        self._distortion = SceneContraction(order="inf") if use_spatial_distortion else None

    def get_density(self, ray_samples: RaySamples):
        positions = ray_samples.frustums.get_positions()
        if self._distortion is not None:
            positions = (self._distortion(positions) + 2.0) / 4.0
        else:
            aabb = torch.tensor(self.aabb, dtype=torch.float32, device=positions.device)
            positions = SceneBox.get_normalized_positions(positions, aabb)
        selector = torch.all((positions > 0.0) & (positions < 1.0), dim=-1, keepdim=True)
        positions = positions * selector
        h = self.mlp_base(positions)
        density = self.average_init_density * trunc_exp(h)
        return density * selector, None

    def get_outputs(self, ray_samples: RaySamples, density_embedding=None):
        return {}
