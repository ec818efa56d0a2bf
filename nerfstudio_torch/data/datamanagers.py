"""Device-resident training data (counterpart of
``nerfstudio_tpu/data/datamanagers.py``): ``DeviceCacheDataManager``'s
uniform-sampler path, where the train images live on the device as one
uint8 stack and a ray batch is a draw of (camera, row, col) plus one
gather, with no host work per step; and splatfacto's
``FullImageDatamanager``. Each is built from tensors or, through
``from_datasets``, from a split's datasets, whose images are uploaded to
the device once. Masks, depth and semantics images, the other pixel
samplers, resolution buckets, image subsetting, farthest-point camera
order and undistortion are not ported: a config asking for one raises."""

from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.datasets import InputDataset
from nerfstudio_torch.data.pixel_samplers import gather_pixels, sample_pixel_indices
from nerfstudio_torch.utils.device import resolve_device


@dataclasses.dataclass
class DataManagerConfig:
    """(reference datamanagers.py:44-61): the same fields and defaults."""

    train_num_rays_per_batch: int = 4096
    eval_num_rays_per_batch: int = 4096
    patch_size: int = 1
    pixel_sampler: Literal["uniform", "equirectangular", "patch", "pair", "fisheye"] = "uniform"
    camera_res_scale_factor: float = 1.0
    max_images_in_memory: Optional[int] = None
    steps_per_reload: int = 1000
    camera_sampling: Literal["random", "fps"] = "random"

    def check_ported(self) -> None:
        """Raise on the options this port does not have yet."""
        missing = {
            f"pixel_sampler={self.pixel_sampler!r}": self.pixel_sampler != "uniform",
            f"patch_size={self.patch_size}": self.patch_size != 1,
            f"camera_res_scale_factor={self.camera_res_scale_factor}": self.camera_res_scale_factor != 1.0,
            f"max_images_in_memory={self.max_images_in_memory}": self.max_images_in_memory is not None,
            f"camera_sampling={self.camera_sampling!r}": self.camera_sampling != "random",
        }
        on = [k for k, v in missing.items() if v]
        if on:
            raise NotImplementedError(f"datamanager options not ported (ROADMAP queue 1 item 5): {', '.join(on)}")


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
        self.train_cameras = self.eval_cameras = cameras.to(device)
        self.num_train_images, self.image_height, self.image_width, self.num_channels = images.shape
        self.train_dataset = self.eval_dataset = None

    @classmethod
    def from_datasets(cls, config: DataManagerConfig, train_dataset: InputDataset,
                      eval_dataset: Optional[InputDataset] = None, device=None) -> "DeviceCacheDataManager":
        """The train split's images, uploaded once, and its cameras (reference
        :66-197); eval images are read from ``eval_dataset`` when asked."""
        config.check_ported()
        dm = cls(config, train_dataset.cameras, torch.from_numpy(train_dataset.load_all()["images"]), device)
        dm.train_dataset = train_dataset
        dm.eval_dataset = eval_dataset or train_dataset
        dm.eval_cameras = dm.eval_dataset.cameras.to(dm.train_images.device)
        return dm

    def eval_image(self, idx: int) -> Tuple[int, Dict[str, np.ndarray]]:
        """(camera index, {"image": float32 (H, W, C)}) of an eval view (reference :379-381)."""
        return idx, {"image": self.eval_dataset.get_image_float32(idx)}

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
        device = resolve_device(device)
        self.train_cameras = cameras.to("cpu")
        self.train_images = images.to(device)
        self.eval_cameras = self.train_cameras if eval_cameras is None else eval_cameras.to("cpu")
        self.eval_images = self.train_images if eval_images is None else eval_images.to(device)
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(images.shape[0])
        self._cursor = 0
        self.train_dataset = self.eval_dataset = None

    @classmethod
    def from_datasets(cls, config: DataManagerConfig, train_dataset: InputDataset,
                      eval_dataset: Optional[InputDataset] = None, device=None) -> "FullImageDatamanager":
        """The train split's uint8 images and the eval split's float32 ones
        (alpha blended as ``InputDataset.get_image_float32`` blends it), each
        uploaded once, the camera order from seed 0 (reference :394-411)."""
        config.check_ported()
        eval_dataset = eval_dataset or train_dataset
        eval_images = np.stack([eval_dataset.get_image_float32(i) for i in range(len(eval_dataset))])
        dm = cls(train_dataset.cameras, torch.from_numpy(train_dataset.load_all()["images"]), eval_dataset.cameras,
                 torch.from_numpy(eval_images), seed=0, device=device)
        dm.train_dataset, dm.eval_dataset = train_dataset, eval_dataset
        return dm

    def rng_state(self) -> Dict:
        """The camera order's state, for a checkpoint: the generator, the
        epoch's permutation and the cursor in it."""
        return {"bit_generator": self._rng.bit_generator.state, "perm": self._perm.tolist(), "cursor": self._cursor}

    def set_rng_state(self, state: Dict) -> None:
        self._rng.bit_generator.state = state["bit_generator"]
        self._perm = np.asarray(state["perm"], dtype=np.int64)
        self._cursor = int(state["cursor"])

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
