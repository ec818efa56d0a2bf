"""Field output names and heads (counterpart of
``nerfstudio_tpu/field_components/field_heads.py``): the density and RGB
heads of the NeRF field, nerfacto's semantic head and its predicted-normal
head, each one linear layer in bfloat16 products with float32 parameters
and output."""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from nerfstudio_torch.utils.device import resolve_device


class FieldHeadNames(enum.Enum):
    """Possible field outputs (reference field_heads.py:12-26)."""

    RGB = "rgb"
    SH = "sh"
    DENSITY = "density"
    NORMALS = "normals"
    PRED_NORMALS = "pred_normals"
    UNCERTAINTY = "uncertainty"
    TRANSIENT_RGB = "transient_rgb"
    TRANSIENT_DENSITY = "transient_density"
    SEMANTICS = "semantics"
    SDF = "sdf"
    ALPHA = "alpha"
    GRADIENT = "gradient"


class FieldHead(nn.Module):
    """A linear layer and an activation (reference field_heads.py:29-42):
    float32 parameters, the product and the bias in bfloat16 as flax's Dense
    computes them at the reference's ``dtype``, the output float32 before
    the activation."""

    def __init__(self, in_dim: int, out_dim: int, activation=None, device=None):
        super().__init__()
        self.layer = nn.Linear(in_dim, out_dim, device=resolve_device(device))
        self.activation = activation
        self.dtype = torch.bfloat16
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's Dense init: LeCun truncated normal kernel, zero bias."""
        with torch.no_grad():
            std = math.sqrt(1.0 / self.layer.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(self.layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            self.layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = Fn.linear(x.to(self.dtype), self.layer.weight.to(self.dtype)) + self.layer.bias.to(self.dtype)
        h = h.to(torch.float32)
        return h if self.activation is None else self.activation(h)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


class DensityFieldHead(FieldHead):
    """Density, softplus of one output (reference field_heads.py:45-48)."""

    def __init__(self, in_dim: int, device=None):
        super().__init__(in_dim, 1, softplus, device)


class RGBFieldHead(FieldHead):
    """Colour, sigmoid of three outputs (reference field_heads.py:51-54)."""

    def __init__(self, in_dim: int, device=None):
        super().__init__(in_dim, 3, torch.sigmoid, device)


class SemanticFieldHead(FieldHead):
    """Per-class logits, no activation (reference field_heads.py:29-42, 87-92)."""

    def __init__(self, in_dim: int, num_classes: int, device=None):
        super().__init__(in_dim, num_classes, None, device)


def tanh_normalize(x: torch.Tensor) -> torch.Tensor:
    """tanh, then divided by its norm floored at 1e-6 (reference
    field_heads.py:95-97)."""
    x = torch.tanh(x)
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-6)


class PredNormalsFieldHead(FieldHead):
    """Predicted normals: three outputs through ``tanh_normalize`` (reference
    field_heads.py:100-105)."""

    def __init__(self, in_dim: int, device=None):
        super().__init__(in_dim, 3, tanh_normalize, device)
