"""Scene bounds (counterpart of ``nerfstudio_tpu/data/scene_box.py``)."""

from __future__ import annotations

import torch


class SceneBox:
    """Axis-aligned scene bounding box. Only the static normaliser is ported."""

    @staticmethod
    def get_normalized_positions(positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
        """Map positions into [0, 1]^3 within the aabb (2, 3) (reference :35-39)."""
        aabb_lengths = aabb[1] - aabb[0]
        return (positions - aabb[0]) / aabb_lengths
