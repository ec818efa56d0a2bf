"""Custom activations (counterpart of
``nerfstudio_tpu/field_components/activations.py``), forward only."""

from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with the exponent clamped at 30, so density cannot overflow f32
    into inf*delta NaNs in the transmittance cumsum (reference :13-16). The
    reference's clamped backward is training work and is not ported."""
    return torch.exp(torch.clamp_max(x, 30.0))
