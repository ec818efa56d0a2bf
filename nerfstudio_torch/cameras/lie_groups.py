"""SO(3)/SE(3) exponential maps (counterpart of
``nerfstudio_tpu/cameras/lie_groups.py``).

Taylor-safe near theta = 0 by ``torch.where`` over both branches, with every
denominator clamped so the untaken branch and its gradient stay finite."""

from __future__ import annotations

import torch

_EPS = 1e-8


def _skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _rodrigues_terms(w: torch.Tensor):
    """Shared Rodrigues terms (reference :27-43); W^2 is w w^T - theta^2 I,
    written out rather than a matrix product."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    theta2_safe = torch.clamp_min(theta2, _EPS * _EPS)
    theta = torch.sqrt(theta2_safe)
    W = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    W2 = w[..., :, None] * w[..., None, :] - theta2[..., None, None] * eye
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    return W, W2, eye, A, B, C


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [t, w] -> (..., 3, 4): Rodrigues rotation, raw translation
    (reference :46-51)."""
    t, w = tangent[..., :3], tangent[..., 3:]
    W, W2, eye, A, B, _ = _rodrigues_terms(w)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    return torch.cat([R, t[..., :, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [t, w] -> (..., 3, 4), the full SE(3) exponential V t
    (reference :54-61)."""
    t, w = tangent[..., :3], tangent[..., 3:]
    W, W2, eye, A, B, C = _rodrigues_terms(w)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    Vt = V[..., :, 0] * t[..., 0:1] + V[..., :, 1] * t[..., 1:2] + V[..., :, 2] * t[..., 2:3]
    return torch.cat([R, Vt[..., :, None]], dim=-1)
