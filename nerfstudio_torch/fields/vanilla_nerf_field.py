"""The NeRF field (counterpart of ``nerfstudio_tpu/fields/vanilla_nerf_field.py``).

Positions (or, for mip-NeRF, the conical frustums' Gaussians through the
integrated encoding) are encoded with their input appended and run through
an 8x256 ReLU MLP with a skip at layer 4; its output is the density
head's input (softplus) and, after the encoded directions, the 2x128 head
MLP's, whose sigmoid head gives the colour. Every MLP and head computes
in bfloat16, as the reference's."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nerfstudio_torch.core.rays import RaySamples
from nerfstudio_torch.field_components.encodings import NeRFEncoding
from nerfstudio_torch.field_components.field_heads import DensityFieldHead, FieldHeadNames, RGBFieldHead
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.base_field import Field
from nerfstudio_torch.utils.device import resolve_device


class NeRFField(Field):
    """(reference vanilla_nerf_field.py:23-86)"""

    def __init__(
        self,
        position_encoding_num_frequencies: int = 10,
        direction_encoding_num_frequencies: int = 4,
        base_mlp_num_layers: int = 8,
        base_mlp_layer_width: int = 256,
        head_mlp_num_layers: int = 2,
        head_mlp_layer_width: int = 128,
        skip_connections: Tuple[int, ...] = (4,),
        use_integrated_encoding: bool = False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.use_integrated_encoding = use_integrated_encoding
        self.position_encoding = NeRFEncoding(3, position_encoding_num_frequencies, 0.0,
                                              float(position_encoding_num_frequencies - 2), include_input=True)
        self.direction_encoding = NeRFEncoding(3, direction_encoding_num_frequencies, 0.0,
                                               float(direction_encoding_num_frequencies - 2), include_input=True)
        self.mlp_base = MLP(self.position_encoding.get_out_dim(), base_mlp_num_layers, base_mlp_layer_width,
                            skip_connections=skip_connections, activation="relu", out_activation="relu",
                            device=device)
        self.mlp_head = MLP(base_mlp_layer_width + self.direction_encoding.get_out_dim(), head_mlp_num_layers,
                            head_mlp_layer_width, activation="relu", out_activation="relu", device=device)
        self.field_output_density = DensityFieldHead(self.mlp_base.get_out_dim(), device=device)
        self.field_output_color = RGBFieldHead(self.mlp_head.get_out_dim(), device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in (self.mlp_base, self.mlp_head, self.field_output_density, self.field_output_color):
            m.reset_parameters(generator)

    def get_density(self, ray_samples: RaySamples):
        if self.use_integrated_encoding:
            gaussians = ray_samples.frustums.get_gaussian_blob()
            encoded = self.position_encoding(gaussians.mean, gaussians.cov)
        else:
            encoded = self.position_encoding(ray_samples.frustums.get_positions())
        base_out = self.mlp_base(encoded)
        return self.field_output_density(base_out), base_out

    def get_outputs(self, ray_samples: RaySamples,
                    density_embedding: Optional[torch.Tensor] = None) -> Dict[FieldHeadNames, torch.Tensor]:
        encoded_dir = self.direction_encoding(ray_samples.frustums.directions)
        head_in = torch.cat([encoded_dir, density_embedding], dim=-1)
        return {FieldHeadNames.RGB: self.field_output_color(self.mlp_head(head_in))}
