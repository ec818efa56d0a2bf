"""Scene colliders (counterpart of
``nerfstudio_tpu/model_components/scene_colliders.py``): ``NearFarCollider``."""

from __future__ import annotations

import dataclasses

import torch

from nerfstudio_torch.core.rays import RayBundle


@dataclasses.dataclass(frozen=True)
class NearFarCollider:
    """Constant near/far planes (reference scene_colliders.py:66-76)."""

    near_plane: float
    far_plane: float

    def __call__(self, ray_bundle: RayBundle, training: bool = True) -> RayBundle:
        near = self.near_plane if training else max(self.near_plane, 1e-4)
        ones = torch.ones_like(ray_bundle.origins[..., :1])
        return dataclasses.replace(ray_bundle, nears=ones * near, fars=ones * self.far_plane)
