"""Device-resident training data (counterpart of the uniform-sampler path
of ``nerfstudio_tpu/data/datamanagers.py`` ``DeviceCacheDataManager``): the
train images live on the device as one uint8 stack, and a ray batch is a
draw of (camera, row, col) plus one gather, with no host work per step.
Dataparsers, masks, depth and semantics images, resolution buckets and
image subsetting are not ported."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.pixel_samplers import gather_pixels, sample_pixel_indices


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
