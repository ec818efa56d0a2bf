"""Learnable per-camera pose corrections (counterpart of
``nerfstudio_tpu/cameras/camera_optimizers.py``).

An (num_cameras, 6) tangent table, zero at init, mapped through the SO3xR3
or SE3 exponential and applied to ray bundles: directions rotated, origins
offset. Full-image models' ``apply_to_camera_pose`` is not ported."""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
from torch import nn

from nerfstudio_torch.cameras.lie_groups import exp_map_SE3, exp_map_SO3xR3
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.utils.device import resolve_device


class CameraOptimizer(nn.Module):
    """(reference camera_optimizers.py:32-86). ``zero_mean_gauge`` subtracts
    the mean tangent over all cameras before the exponential, which pins
    the 6-DoF drift of every camera at once that the photometric loss
    cannot see."""

    def __init__(
        self,
        num_cameras: int,
        mode: Literal["off", "SO3xR3", "SE3"] = "off",
        zero_mean_gauge: bool = False,
        device=None,
    ):
        super().__init__()
        if mode not in ("off", "SO3xR3", "SE3"):
            raise ValueError(mode)
        self.num_cameras = num_cameras
        self.mode = mode
        self.zero_mean_gauge = zero_mean_gauge
        if mode != "off":
            self.pose_adjustment = nn.Parameter(torch.zeros((num_cameras, 6), device=resolve_device(device)))

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """indices: (...,) int -> (..., 3, 4) correction transforms."""
        if self.mode == "off":
            eye = torch.eye(4, device=indices.device)[:3]
            return eye.expand(indices.shape + (3, 4))
        adjustment = self.pose_adjustment
        if self.zero_mean_gauge:
            adjustment = adjustment - torch.mean(adjustment, dim=0, keepdim=True)
        tangent = adjustment[indices.long()]
        if self.mode == "SO3xR3":
            return exp_map_SO3xR3(tangent)
        return exp_map_SE3(tangent)

    def apply_to_raybundle(self, ray_bundle: RayBundle) -> RayBundle:
        """Rotate directions and offset origins (reference :74-86)."""
        if self.mode == "off":
            return ray_bundle
        assert ray_bundle.camera_indices is not None
        correction = self(ray_bundle.camera_indices[..., 0])  # (..., 3, 4)
        R = correction[..., :3, :3]
        d = ray_bundle.directions
        directions = R[..., :, 0] * d[..., 0:1] + R[..., :, 1] * d[..., 1:2] + R[..., :, 2] * d[..., 2:3]
        return dataclasses.replace(
            ray_bundle, origins=ray_bundle.origins + correction[..., :3, 3], directions=directions
        )


def camera_opt_regularizer(
    pose_adjustment: torch.Tensor, trans_l2_penalty: float, rot_l2_penalty: float
) -> torch.Tensor:
    """L2 penalty on the tangents (reference :89-101), with a safe norm whose
    gradient is finite at the all-zero init."""

    def _norm(x):
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12)

    return (
        torch.mean(_norm(pose_adjustment[:, :3])) * trans_l2_penalty
        + torch.mean(_norm(pose_adjustment[:, 3:])) * rot_l2_penalty
    )
