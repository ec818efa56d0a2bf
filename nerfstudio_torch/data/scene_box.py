"""Scene bounds (counterpart of ``nerfstudio_tpu/data/scene_box.py``)."""

from __future__ import annotations

import dataclasses
from typing import Union

import torch


@dataclasses.dataclass
class SceneBox:
    """Axis-aligned scene bounding box. aabb: (2, 3) [[min], [max]]."""

    aabb: torch.Tensor

    def within(self, pts: torch.Tensor) -> torch.Tensor:
        """Boolean mask of points inside the box."""
        return torch.all((pts > self.aabb[0]) & (pts < self.aabb[1]), dim=-1)

    def get_diagonal_length(self) -> torch.Tensor:
        diff = self.aabb[1] - self.aabb[0]
        return torch.sqrt(torch.sum(diff**2))

    def get_center(self) -> torch.Tensor:
        return (self.aabb[0] + self.aabb[1]) / 2.0

    def get_centered_and_scaled_scene_box(self, scale_factor: Union[float, torch.Tensor] = 1.0) -> "SceneBox":
        return SceneBox(aabb=(self.aabb - self.get_center()) * scale_factor)

    @staticmethod
    def get_normalized_positions(positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
        """Map positions into [0, 1]^3 within the aabb (2, 3) (reference :35-39)."""
        aabb_lengths = aabb[1] - aabb[0]
        return (positions - aabb[0]) / aabb_lengths

    @staticmethod
    def from_camera_poses(poses: torch.Tensor, scale_factor: float) -> "SceneBox":
        xyzs = poses[..., :3, -1]
        aabb = torch.stack([xyzs.min(dim=0).values, xyzs.max(dim=0).values])
        return SceneBox(aabb=aabb * scale_factor)

