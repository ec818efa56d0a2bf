"""Custom activations (counterpart of
``nerfstudio_tpu/field_components/activations.py``)."""

from __future__ import annotations

import torch

from nerfstudio_torch.utils.math import clip


class _TruncExp(torch.autograd.Function):
    """exp with the exponent clamped at 30 in the forward, so density cannot
    overflow f32 into inf*delta NaNs in the transmittance cumsum; the
    gradient is ``g * exp(clip(x, -15, 15))`` (reference :13-28). The
    backward is plain differentiable ops, so autograd takes its derivative
    as the reference's autodiff of its ``custom_vjp`` backward does (the
    normals' loss): ``g * exp(clip(x)) * clip'(x)``, with jnp.clip's 1/2 at
    a bound (``utils.math.clip``; ``torch.clamp`` would pass 1 there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp_max(x, 30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(clip(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
