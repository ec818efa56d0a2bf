"""TensoRF field (counterpart of ``nerfstudio_tpu/fields/tensorf_field.py``).

Two vector-matrix decompositions over K8 (``ops/interp.py``): the density
is the ReLU of the sum of one's features; the other's features go through
``B`` (a linear map without bias, float32) to the appearance features,
whose 2-frequency encoding joins the directions' and the features
themselves, ``[rgb_features, d_enc, f_enc]``, in a bfloat16 head MLP with a
sigmoid output. Positions are normalised to [-1, 1]^3 by the aabb."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from nerfstudio_torch.core.rays import RaySamples
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.field_components.encodings import NeRFEncoding, TensorVMEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.base_field import Field
from nerfstudio_torch.ops.interp import resize_linear
from nerfstudio_torch.utils.device import resolve_device


class TensoRFField(Field):
    """(reference tensorf_field.py:21-73)"""

    def __init__(
        self,
        aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
        density_resolution: int = 128,
        color_resolution: int = 128,
        density_components: int = 16,
        color_components: int = 48,
        appearance_dim: int = 27,
        head_mlp_num_layers: int = 2,
        head_mlp_layer_width: int = 128,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("aabb", torch.tensor(aabb, dtype=torch.float32, device=device), persistent=False)
        self.density_encoding = TensorVMEncoding(density_resolution, density_components, device=device)
        self.color_encoding = TensorVMEncoding(color_resolution, color_components, device=device)
        self.feature_encoding = NeRFEncoding(appearance_dim, num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0)
        self.direction_encoding = NeRFEncoding(3, num_frequencies=2, min_freq_exp=0.0, max_freq_exp=1.0)
        self.B = nn.Linear(self.color_encoding.get_out_dim(), appearance_dim, bias=False, device=device)
        head_in = appearance_dim + self.direction_encoding.get_out_dim() + self.feature_encoding.get_out_dim()
        self.head = MLP(head_in, head_mlp_num_layers, head_mlp_layer_width, out_dim=3, out_activation="sigmoid",
                        device=device)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The encodings' normal draws, ``B`` and the head as flax's Dense
        (LeCun truncated normal, zero biases)."""
        self.density_encoding.reset_parameters(generator)
        self.color_encoding.reset_parameters(generator)
        with torch.no_grad():
            std = math.sqrt(1.0 / self.B.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(self.B.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.head.reset_parameters(generator)

    def _normalized(self, ray_samples: RaySamples) -> torch.Tensor:
        positions = ray_samples.frustums.get_positions()
        return SceneBox.get_normalized_positions(positions, self.aabb) * 2.0 - 1.0

    def get_density(self, ray_samples: RaySamples):
        feats = self.density_encoding(self._normalized(ray_samples))
        return torch.relu(torch.sum(feats, dim=-1, keepdim=True)), None

    def get_outputs(self, ray_samples: RaySamples, density_embedding=None) -> Dict[FieldHeadNames, torch.Tensor]:
        rgb_features = Fn.linear(self.color_encoding(self._normalized(ray_samples)), self.B.weight)
        d_enc = self.direction_encoding(ray_samples.frustums.directions)
        f_enc = self.feature_encoding(rgb_features)
        return {FieldHeadNames.RGB: self.head(torch.cat([rgb_features, d_enc, f_enc], dim=-1))}

    @torch.no_grad()
    def upsample(self, resolution: int) -> None:
        """Both decompositions' planes and lines resampled to ``resolution``
        with K8's ``resize_linear`` (``jax.image.resize`` "linear"), in
        place: the parameters keep their identity, so an optimizer holding
        them stays bound (its state must be reset, as the reference
        re-initialises it)."""
        for enc in (self.density_encoding, self.color_encoding):
            plane, line = enc.plane_coef, enc.line_coef
            p = resize_linear(plane.reshape((-1,) + tuple(plane.shape[2:])), (resolution, resolution))
            plane.data = p.reshape(plane.shape[:2] + (resolution, resolution)).contiguous()
            line.data = resize_linear(line.reshape((-1, line.shape[-1])), (resolution,)).reshape(
                line.shape[:2] + (resolution,)).contiguous()
            enc.resolution = resolution
