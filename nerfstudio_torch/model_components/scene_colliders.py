"""Scene colliders (counterpart of
``nerfstudio_tpu/model_components/scene_colliders.py``): ``AABBBoxCollider``,
``NearFarCollider`` and ``SphereCollider``."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from nerfstudio_torch.core.rays import RayBundle


@dataclasses.dataclass(frozen=True)
class AABBBoxCollider:
    """Slab test against the scene box (reference scene_colliders.py:17-37):
    a direction component under 1e-10 in magnitude is taken as 1e-10; nears
    at least ``near_plane`` in training (0 at eval), fars at least nears +
    1e-6, so a ray that misses the box gets an empty interval past it."""

    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]]
    near_plane: float = 0.0

    def __call__(self, ray_bundle: RayBundle, training: bool = True) -> RayBundle:
        aabb = torch.tensor(self.aabb, dtype=torch.float32, device=ray_bundle.origins.device)
        d, o = ray_bundle.directions, ray_bundle.origins
        inv_d = 1.0 / torch.where(torch.abs(d) < 1e-10, torch.full_like(d, 1e-10), d)
        t_min = (aabb[0] - o) * inv_d
        t_max = (aabb[1] - o) * inv_d
        nears = torch.amax(torch.minimum(t_min, t_max), dim=-1, keepdim=True)
        fars = torch.amin(torch.maximum(t_min, t_max), dim=-1, keepdim=True)
        nears = torch.clamp_min(nears, self.near_plane if training else 0.0)
        fars = torch.maximum(fars, nears + 1e-6)
        return dataclasses.replace(ray_bundle, nears=nears, fars=fars)


@dataclasses.dataclass(frozen=True)
class SphereCollider:
    """Ray/sphere intersection (reference scene_colliders.py:41-64): nears and
    fars where the ray meets the sphere; a ray that misses gets the closest
    approach for both, then fars = max(fars, nears + 1e-6)."""

    center: Tuple[float, float, float]
    radius: float
    soft_intersect_scale: float = 1.0
    near_plane: float = 0.0

    def __call__(self, ray_bundle: RayBundle, training: bool = True) -> RayBundle:
        o = ray_bundle.origins - torch.tensor(self.center, dtype=torch.float32, device=ray_bundle.origins.device)
        d = ray_bundle.directions
        a = torch.sum(d * d, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(o * d, dim=-1, keepdim=True)
        c = torch.sum(o * o, dim=-1, keepdim=True) - self.radius**2
        disc = b**2 - 4 * a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0)) * self.soft_intersect_scale
        nears = (-b - sq) / (2 * a)
        fars = (-b + sq) / (2 * a)
        nears = torch.clamp_min(nears, self.near_plane if training else 0.0)
        fars = torch.maximum(fars, nears + 1e-6)
        return dataclasses.replace(ray_bundle, nears=nears, fars=fars)


@dataclasses.dataclass(frozen=True)
class NearFarCollider:
    """Constant near/far planes (reference scene_colliders.py:66-76)."""

    near_plane: float
    far_plane: float

    def __call__(self, ray_bundle: RayBundle, training: bool = True) -> RayBundle:
        near = self.near_plane if training else max(self.near_plane, 1e-4)
        ones = torch.ones_like(ray_bundle.origins[..., :1])
        return dataclasses.replace(ray_bundle, nears=ones * near, fars=ones * self.far_plane)
