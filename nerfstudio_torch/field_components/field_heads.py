"""Field output names and heads (counterpart of
``nerfstudio_tpu/field_components/field_heads.py``). Of the head modules
the semantic head is ported (the other heads belong to fields the port
does not have yet)."""

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


class SemanticFieldHead(nn.Module):
    """Per-class logits, a linear layer with no activation (reference
    field_heads.py:29-42, 87-92): float32 parameters, the product and the
    bias in bfloat16 as flax's Dense computes them at the reference's
    ``dtype``, the output float32."""

    def __init__(self, in_dim: int, num_classes: int, device=None):
        super().__init__()
        self.layer = nn.Linear(in_dim, num_classes, device=resolve_device(device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's Dense init: LeCun truncated normal kernel, zero bias."""
        with torch.no_grad():
            std = math.sqrt(1.0 / self.layer.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(self.layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            self.layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = Fn.linear(x.to(torch.bfloat16), self.layer.weight.to(torch.bfloat16)) + self.layer.bias.to(torch.bfloat16)
        return h.to(torch.float32)
