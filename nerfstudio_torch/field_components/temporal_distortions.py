"""D-NeRF's temporal distortion (counterpart of
``nerfstudio_tpu/field_components/temporal_distortions.py``).

A deformation network: each sample's position, encoded with 10
frequencies (2^0 .. 2^8, the input appended), beside its time, encoded
the same way (84 features), runs through a 4-layer 256-wide ReLU MLP
(products in bfloat16, as the reference's) to a 3-vector offset; the
distortion returns ``positions + offsets``. The MLP's skip at layer 4 is
the output layer's index of a 4-layer net, which never reads a skip, as in
the reference."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from nerfstudio_torch.field_components.encodings import NeRFEncoding
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.utils.device import resolve_device


class DNeRFDistortion(nn.Module):
    """(reference temporal_distortions.py:18-47)"""

    def __init__(self, mlp_num_layers: int = 4, mlp_layer_width: int = 256,
                 skip_connections: Tuple[int, ...] = (4,), device=None):
        super().__init__()
        self.position_encoding = NeRFEncoding(3, 10, 0.0, 8.0, include_input=True)
        self.temporal_encoding = NeRFEncoding(1, 10, 0.0, 8.0, include_input=True)
        in_dim = self.position_encoding.get_out_dim() + self.temporal_encoding.get_out_dim()
        self.mlp = MLP(in_dim, mlp_num_layers, mlp_layer_width, out_dim=3, skip_connections=skip_connections,
                       device=resolve_device(device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, positions: torch.Tensor, times: Optional[torch.Tensor]) -> torch.Tensor:
        """positions (..., 3), times (..., 1) -> the distorted positions
        (..., 3); the positions themselves without times."""
        if times is None:
            return positions
        feat = torch.cat([self.position_encoding(positions), self.temporal_encoding(times)], dim=-1)
        return positions + self.mlp(feat)
