"""Random-camera datamanager for text-to-3D (counterpart of
``nerfstudio_tpu/data/random_cameras_datamanager.py``).

Synthesises a random orbit camera each step (no images: the SDS loss
supervises the renders directly) and a fixed ring of eval cameras. The draws
come from numpy's ``default_rng(seed)`` in the reference's order, so the
cameras equal the reference's bit for bit; they are built on the requested
device (None: the GPU)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.utils.device import resolve_device


@dataclasses.dataclass
class RandomCamerasConfig:
    num_eval_angles: int = 8
    train_resolution: int = 64
    eval_resolution: int = 256
    radius_mean: float = 2.5
    radius_std: float = 0.1
    vertical_rotation_range: Tuple[float, float] = (-90.0, 20.0)
    focal_range: Tuple[float, float] = (0.7, 1.35)
    jitter_std: float = 0.05


class RandomCamerasDataManager:
    def __init__(self, config: RandomCamerasConfig, seed: int = 0, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)

    def _camera_at(self, vertical_deg: float, horizontal_deg: float, radius: float, focal_mult: float,
                   res: int) -> Cameras:
        """A pinhole camera at ``radius`` on the sphere, looking at the origin."""
        v = np.deg2rad(vertical_deg)
        h = np.deg2rad(horizontal_deg)
        pos = radius * np.array([np.cos(v) * np.cos(h), np.cos(v) * np.sin(h), np.sin(v)])
        forward = pos / np.linalg.norm(pos)
        up = np.array([0.0, 0, 1])
        if abs(forward @ up) > 0.99:
            up = np.array([0.0, 1, 0])
        right = np.cross(up, forward)
        right /= np.linalg.norm(right)
        true_up = np.cross(forward, right)
        c2w = np.stack([right, true_up, forward, pos], axis=1).astype(np.float32)
        focal = focal_mult * res
        return Cameras.create(c2w[None], fx=focal, fy=focal, cx=res / 2, cy=res / 2, width=res, height=res,
                              device=self.device)

    def next_train(self, step: int) -> Tuple[Cameras, float, float]:
        """(Cameras of one, vertical degrees, horizontal degrees)."""
        cfg = self.config
        v = self._rng.uniform(*cfg.vertical_rotation_range)
        h = self._rng.uniform(0, 360)
        r = self._rng.normal(cfg.radius_mean, cfg.radius_std)
        f = self._rng.uniform(*cfg.focal_range)
        return self._camera_at(v, h, r, f, cfg.train_resolution), v, h

    def eval_cameras(self) -> List[Cameras]:
        cfg = self.config
        return [self._camera_at(-10.0, 360.0 * i / cfg.num_eval_angles, cfg.radius_mean, 1.0, cfg.eval_resolution)
                for i in range(cfg.num_eval_angles)]
