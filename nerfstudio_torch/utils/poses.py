"""3x4 pose helpers (counterpart of ``nerfstudio_tpu/utils/poses.py``): the
composition that applies a camera-opt correction to a camera."""

from __future__ import annotations

import torch


def multiply(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Compose two (..., 3, 4) rigid transforms, a @ b (reference :24-28)."""
    Ra, ta = pose_a[..., :3, :3], pose_a[..., :3, 3:]
    R = torch.matmul(Ra, pose_b[..., :3, :3])
    t = ta + torch.matmul(Ra, pose_b[..., :3, 3:])
    return torch.cat([R, t], dim=-1)
