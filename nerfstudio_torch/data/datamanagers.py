"""Device-resident training data (counterpart of
``nerfstudio_tpu/data/datamanagers.py``): ``DeviceCacheDataManager``'s
uniform-sampler path, where the train images live on the device as one
uint8 stack and a ray batch is a draw of (camera, row, col) plus one
gather, with no host work per step; and splatfacto's
``FullImageDatamanager``. Dataparsers, masks, depth and semantics images,
resolution buckets and image subsetting are not ported."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.pixel_samplers import gather_pixels, sample_pixel_indices
from nerfstudio_torch.utils.device import resolve_device


@dataclasses.dataclass
class DataManagerConfig:
    """(reference datamanagers.py:34-61), the field the uniform path reads."""

    train_num_rays_per_batch: int = 4096


class DeviceCacheDataManager:
    """Train images (N, H, W, C) uint8 and their cameras, on one device."""

    def __init__(self, config: DataManagerConfig, cameras: Cameras, images: torch.Tensor, device=None):
        if images.ndim != 4:
            raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
        if not cameras.all_perspective():
            raise NotImplementedError("only perspective cameras are ported")
        device = resolve_device(device)
        self.config = config
        self.train_images = images.to(device)
        self.train_cameras = dataclasses.replace(
            cameras, **{f.name: getattr(cameras, f.name).to(device) for f in dataclasses.fields(cameras)}
        )
        self.num_train_images, self.image_height, self.image_width, self.num_channels = images.shape

    def sample_train_batch(
        self,
        generator: Optional[torch.Generator] = None,
        num_rays: Optional[int] = None,
        indices: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (ray indices (R, 3) (camera, row, col), {"image": (R, C),
        "indices": ...}) (reference :322-374). ``indices`` hands the draw in;
        otherwise it comes from ``generator``."""
        if indices is None:
            indices = sample_pixel_indices(
                num_rays or self.config.train_num_rays_per_batch, self.num_train_images,
                self.image_height, self.image_width, generator=generator, device=self.train_images.device,
            )
        indices = indices.to(self.train_images.device)
        return indices, {"image": gather_pixels(self.train_images, indices), "indices": indices}


class FullImageDatamanager:
    """Full-image batches for splatfacto (reference ``FullImageDatamanager``,
    datamanagers.py:387-442): the train images live on the device, the
    cameras on the host (the projection reads them there), and the camera
    order is a host ``np.random.default_rng(seed)`` permutation, redrawn
    each epoch, the same draw as the reference's for the same seed.
    Farthest-point camera order and undistortion are not ported."""

    def __init__(self, cameras: Cameras, images: torch.Tensor, eval_cameras: Optional[Cameras] = None,
                 eval_images: Optional[torch.Tensor] = None, seed: int = 0, device=None):
        if images.ndim != 4:
            raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
        if not cameras.all_perspective():
            raise NotImplementedError("only perspective cameras are ported")
        host = lambda c: dataclasses.replace(  # noqa: E731
            c, **{f.name: getattr(c, f.name).cpu() for f in dataclasses.fields(c)})
        device = resolve_device(device)
        self.train_cameras = host(cameras)
        self.train_images = images.to(device)
        self.eval_cameras = self.train_cameras if eval_cameras is None else host(eval_cameras)
        self.eval_images = self.train_images if eval_images is None else eval_images.to(device)
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(images.shape[0])
        self._cursor = 0

    def next_train(self, step: int) -> Tuple[int, torch.Tensor]:
        """(camera index, float32 (H, W, C) image in [0, 1])."""
        if self._cursor >= len(self._perm):
            self._perm = self._rng.permutation(len(self._perm))
            self._cursor = 0
        idx = int(self._perm[self._cursor])
        self._cursor += 1
        return idx, _as_float(self.train_images[idx])

    def eval_image(self, idx: int) -> torch.Tensor:
        return _as_float(self.eval_images[idx])


def _as_float(img: torch.Tensor) -> torch.Tensor:
    return img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img
