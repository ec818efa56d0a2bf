"""Device-resident training data (counterpart of
``nerfstudio_tpu/data/datamanagers.py``).

``DeviceCacheDataManager``: the train images live on the device as uint8
stacks and a ray batch is a draw of (camera, row, col) plus one gather, with
no host work per step. The uniform, fisheye, equirectangular, patch and
pair samplers; masked sampling from a table of the mask-valid pixels; a
mixed-resolution split as one stack per resolution, each drawing a fixed
share of the rays (masked too); and, with ``max_images_in_memory``, a
resident subset of the images, swapped for another every
``steps_per_reload`` steps. splatfacto's ``FullImageDatamanager`` undistorts
its train images on the host once and orders its cameras at random or by
farthest point. Each is built from tensors or, through ``from_datasets``,
from a split's datasets, whose images are uploaded to the device once.
A split's per-pixel depths (depth-nerfacto) and class labels
(semantic-nerfw) live on the device beside its images, as (N, H, W, 1)
float32 and int32 stacks, subset with the resident images and gathered
with each batch's indices into ``depth_image`` and ``semantics``; a
bucketed split carries depths, not labels, as the reference does.
``camera_res_scale_factor`` is declared and never read, as in the
reference."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.datasets import InputDataset
from nerfstudio_torch.data.pixel_samplers import (
    _unit_table,
    build_valid_indices,
    gather_pixels,
    sample_pair_pixel_indices,
    sample_patch_pixel_indices,
    sample_pixel_indices,
    sample_pixel_indices_equirectangular,
    sample_pixel_indices_fisheye,
    sample_pixel_indices_from_valid,
)
from nerfstudio_torch.data.undistort import maybe_undistort_dataset
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


Images = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class DeviceCacheDataManager:
    """Train images and their cameras on one device (reference :64-384).
    ``images`` is one (N, H, W, C) uint8 stack, with ``masks`` (N, H, W, 1)
    bool, ``depths`` (N, H, W, 1) float32 and ``semantics`` (N, H, W, 1)
    int32 where the split has them; or ``buckets``, a mixed-resolution
    split as ``InputDataset.load_all_bucketed`` gives it (depths included).
    An RGBA bucket among RGB ones is blended over ``alpha_color`` (None:
    black) first."""

    def __init__(self, config: DataManagerConfig, cameras: Cameras, images=None, device=None, masks=None,
                 buckets: Optional[List[Dict[str, np.ndarray]]] = None, alpha_color=None, depths=None,
                 semantics=None):
        device = resolve_device(device)
        self.config = config
        self.device = device
        self.train_cameras = self.eval_cameras = cameras.to(device)
        self.train_dataset = self.eval_dataset = None
        self._buckets = buckets
        self.bucket_valid = None
        self.bucket_depths = None
        self.valid_indices = None
        # (N, H, W, 1) float32 depths and int32 labels of the whole split,
        # on the host; the resident ones go to the device
        self._all_depths = None if depths is None else torch.as_tensor(np.asarray(depths, np.float32))
        self._all_semantics = None if semantics is None else torch.as_tensor(np.asarray(semantics, np.int32))
        if buckets is not None and semantics is not None:
            raise NotImplementedError("semantic labels of a mixed-resolution split are not supported (as in the "
                                      "reference): the labels are gathered from one stack")
        if buckets is None:
            images = torch.as_tensor(images)
            if images.ndim != 4:
                raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
            self._all_images = images
            self.num_train_images, h, w, c = images.shape
        else:
            self._all_images = None
            self.num_train_images = sum(len(b["camera_indices"]) for b in buckets)
            c = min(b["images"].shape[-1] for b in buckets)
            h, w = buckets[0]["images"].shape[1:3]
            if c == 3:  # RGB and RGBA buckets: blend the RGBA ones before truncating (reference :99-111)
                bg = np.zeros(3, np.float32) if alpha_color is None else np.asarray(alpha_color, np.float32)
                for b in buckets:
                    if b["images"].shape[-1] == 4:
                        im = b["images"].astype(np.float32) / 255.0
                        rgb = im[..., :3] * im[..., 3:] + bg * (1.0 - im[..., 3:])
                        b["images"] = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
        self.image_height, self.image_width, self.num_channels = h, w, c

        m = config.max_images_in_memory
        self._subsetting = m is not None and m < self.num_train_images
        has_masks = masks is not None or (buckets is not None and any("masks" in b for b in buckets))
        if self._subsetting and has_masks:
            raise NotImplementedError("max_images_in_memory with per-pixel masks is unsupported: the mask-valid "
                                      "index tables are built over the full image stacks (as in the reference)")
        if buckets is not None:
            self.train_depths = self.train_semantics = None  # the buckets carry their own depths
            has_depths = any("depths" in b for b in buckets)
            if self._subsetting and has_depths:
                raise NotImplementedError("max_images_in_memory with bucketed depth supervision is unsupported (as "
                                          "in the reference): the depth stacks are not reloaded with the images")
            if self._subsetting:
                # fixed per-bucket resident counts, proportional to bucket size
                sizes = np.array([len(b["camera_indices"]) for b in buckets])
                mb = np.maximum(1, (m * sizes / sizes.sum()).astype(int))
                self._bucket_resident_counts = tuple(int(min(x, s)) for x, s in zip(mb, sizes))
                self._load_bucket_subset(np.random.default_rng(0))
            else:
                self.train_images = tuple(self._put(b["images"]) for b in buckets)
                self.bucket_cam_maps = tuple(self._put(b["camera_indices"]) for b in buckets)
                self.resident_map = None
                if has_depths:
                    self.bucket_depths = tuple(self._put(b["depths"]) for b in buckets)
            if has_masks:
                self.bucket_valid = tuple(self._put(build_valid_indices(b["masks"])) for b in buckets)
        else:
            self._load_subset(self._select_subset(np.random.default_rng(0)))
            if masks is not None:
                self.valid_indices = self._put(build_valid_indices(np.asarray(masks)))

    @classmethod
    def from_datasets(cls, config: DataManagerConfig, train_dataset: InputDataset,
                      eval_dataset: Optional[InputDataset] = None, device=None) -> "DeviceCacheDataManager":
        """The train split's images (and masks, depths and class labels),
        uploaded once, and its cameras; a mixed-resolution split as
        resolution buckets (reference :66-197). Eval images are read from
        ``eval_dataset`` when asked."""
        try:
            data = train_dataset.load_all()
        except ValueError:  # a mixed-resolution capture (reference :76-84)
            data = None
        if data is None:
            if getattr(train_dataset, "semantics", None) is not None:
                print("[datamanager] WARNING: a mixed-resolution split's semantic labels are not used (as in the "
                      "reference): the buckets carry images, masks and depths", flush=True)
            dm = cls(config, train_dataset.cameras, device=device, buckets=train_dataset.load_all_bucketed(),
                     alpha_color=train_dataset.alpha_color)
        else:
            metas = [train_dataset.get_metadata(i) for i in range(len(train_dataset))]

            def stack(key, dtype):  # the split's per-pixel maps of ``key``, if it has them
                return np.stack([m[key] for m in metas]).astype(dtype) if metas and key in metas[0] else None

            dm = cls(config, train_dataset.cameras, torch.from_numpy(data["images"]), device, masks=data.get("masks"),
                     depths=stack("depth_image", np.float32), semantics=stack("semantics", np.int32))
        dm.train_dataset = train_dataset
        dm.eval_dataset = eval_dataset or train_dataset
        dm.eval_cameras = dm.eval_dataset.cameras.to(dm.device)
        return dm

    def _put(self, arr) -> torch.Tensor:
        t = torch.as_tensor(arr).to(self.device)
        return t.long() if t.dtype == torch.int32 else t

    # -- the resident subset -------------------------------------------
    def _select_subset(self, rng) -> np.ndarray:
        m = self.config.max_images_in_memory
        if m is None or m >= self.num_train_images:
            return np.arange(self.num_train_images)
        return rng.choice(self.num_train_images, size=m, replace=False)

    def _load_subset(self, subset: np.ndarray) -> None:
        """Upload the resident images and their slot -> camera map
        (reference :205-223)."""
        pick = (lambda x: x) if not self._subsetting else (lambda x: x[torch.from_numpy(subset)])
        self.train_images = pick(self._all_images).to(self.device)
        self.train_depths = None if self._all_depths is None else pick(self._all_depths).to(self.device)
        self.train_semantics = None if self._all_semantics is None else pick(self._all_semantics).to(self.device)
        self._resident = subset
        self.resident_map = self._put(np.asarray(subset, np.int32))

    def _load_bucket_subset(self, rng) -> None:
        """Per bucket, a fixed number of its images at random, and the slot
        -> camera maps as ``resident_map`` (reference :225-240)."""
        imgs, cmaps = [], []
        for b, mb in zip(self._buckets, self._bucket_resident_counts):
            size = len(b["camera_indices"])
            pick = rng.choice(size, size=mb, replace=False) if mb < size else np.arange(size)
            imgs.append(self._put(b["images"][pick]))
            cmaps.append(self._put(b["camera_indices"][pick]))
        self.train_images = tuple(imgs)
        self.bucket_cam_maps = tuple(cmaps)
        self.resident_map = tuple(cmaps)

    def maybe_reload(self, step: int, rng=None) -> None:
        """Swap the resident subset on the reload cadence (reference
        :242-256), from ``np.random.default_rng(step)`` unless given."""
        if not self._subsetting or step % self.config.steps_per_reload != 0:
            return
        rng = rng or np.random.default_rng(step)
        if self._buckets is not None:
            self._load_bucket_subset(rng)
        else:
            self._load_subset(self._select_subset(rng))

    # -- sampling -------------------------------------------------------
    def _bucket_ray_alloc(self, num_rays: int) -> Tuple[int, ...]:
        """Rays per bucket in proportion to its pixels (its mask-valid ones
        where masked), each at least 1, summing to ``num_rays`` (reference
        :258-293)."""
        if num_rays < len(self._buckets):
            raise ValueError(f"num_rays={num_rays} < {len(self._buckets)} resolution buckets: every bucket needs "
                             ">= 1 ray per batch (raise the ray budget)")
        if self.bucket_valid is not None:
            pix = np.array([v.shape[0] for v in self.bucket_valid], np.float64)
        elif self._subsetting:
            pix = np.array([mb * b["images"].shape[1] * b["images"].shape[2]
                            for mb, b in zip(self._bucket_resident_counts, self._buckets)], np.float64)
        else:
            pix = np.array([b["images"].shape[0] * b["images"].shape[1] * b["images"].shape[2]
                            for b in self._buckets], np.float64)
        alloc = np.maximum(1, np.floor(num_rays * pix / pix.sum()).astype(int))
        while alloc.sum() < num_rays:  # the remainder to the largest buckets
            alloc[np.argmax(pix / alloc)] += 1
        while alloc.sum() > num_rays:
            alloc[int(np.argmax(alloc))] -= 1
        return tuple(int(a) for a in alloc)

    def _draw_indices(self, num_rays: int, num_images: int, generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(num_rays, 3) (slot, row, col) from the mask-valid table where
        there is one, else from the configured sampler (reference
        :346-368)."""
        h, w, valid = self.image_height, self.image_width, self.valid_indices
        kw = dict(generator=generator, device=self.device)
        sampler = self.config.pixel_sampler
        if valid is not None:
            return sample_pixel_indices_from_valid(num_rays, valid, generator)
        if sampler == "equirectangular":
            return sample_pixel_indices_equirectangular(num_rays, num_images, h, w, **kw)
        if sampler == "fisheye":
            return sample_pixel_indices_fisheye(num_rays, num_images, h, w, **kw)
        if sampler == "patch":
            return sample_patch_pixel_indices(num_rays, self.config.patch_size, num_images, h, w, **kw)
        if sampler == "pair":
            return sample_pair_pixel_indices(num_rays, num_images, h, w, **kw)
        return sample_pixel_indices(num_rays, num_images, h, w, **kw)

    def _sample_train_batch_bucketed(self, generator, images, num_rays, indices, cam_maps):
        """(reference :295-320) Each bucket's share of the rays, drawn
        uniformly over its pixels or its mask-valid table, with its depths
        where the buckets carry them."""
        alloc = self._bucket_ray_alloc(num_rays)
        valids = self.bucket_valid or (None,) * len(images)
        depths = self.bucket_depths or (None,) * len(images)
        idx_parts, rgb_parts, depth_parts = [], [], []
        for b, (img, cmap, valid, dep, r) in enumerate(zip(images, cam_maps, valids, depths, alloc)):
            if indices is not None:
                idx_b = indices[b].to(self.device).long()
            elif valid is not None:
                idx_b = sample_pixel_indices_from_valid(r, valid, generator)
            else:
                idx_b = sample_pixel_indices(r, img.shape[0], img.shape[1], img.shape[2], generator, self.device)
            rgb_parts.append(gather_pixels(img, idx_b))
            if dep is not None:
                depth_parts.append(gather_pixels(dep, idx_b))
            idx_parts.append(torch.cat([cmap[idx_b[:, 0]][:, None], idx_b[:, 1:]], dim=-1))
        idx = torch.cat(idx_parts, dim=0)
        batch = {"image": torch.cat(rgb_parts, dim=0), "indices": idx}
        if depth_parts:
            batch["depth_image"] = torch.cat(depth_parts, dim=0)
        return idx, batch

    def sample_train_batch(
        self,
        generator: Optional[torch.Generator] = None,
        num_rays: Optional[int] = None,
        indices: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None,
        images: Optional[Images] = None,
        resident_map: Optional[Union[torch.Tensor, Tuple[torch.Tensor, ...]]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (ray indices (R, 3) (camera, row, col), {"image": (R, C),
        "indices": ...[, "depth_image": (R, 1) float32][, "semantics": (R,
        1) int32]}) (reference :322-376). ``indices`` hands the draw in:
        the (slot, row, col) rows into ``images`` (a tuple of them, one per
        bucket, for a bucketed split); otherwise they come from
        ``generator``. ``images`` and ``resident_map`` default to the
        resident ones; the returned indices carry the original cameras."""
        num_rays = num_rays or self.config.train_num_rays_per_batch
        images = self.train_images if images is None else images
        if isinstance(images, (tuple, list)):
            cam_maps = self.bucket_cam_maps if resident_map is None else resident_map
            return self._sample_train_batch_bucketed(generator, images, num_rays, indices, cam_maps)
        if resident_map is None and self._subsetting:
            resident_map = self.resident_map
        if indices is None:
            indices = self._draw_indices(num_rays, images.shape[0], generator)
        indices = indices.to(self.device).long()
        batch = {"image": gather_pixels(images, indices)}
        if self.train_depths is not None:
            batch["depth_image"] = gather_pixels(self.train_depths, indices)
        if self.train_semantics is not None:
            batch["semantics"] = gather_pixels(self.train_semantics, indices)
        if resident_map is not None:  # resident slot -> original camera
            indices = torch.cat([resident_map[indices[:, 0]][:, None], indices[:, 1:]], dim=-1)
        batch["indices"] = indices
        return indices, batch

    def eval_image(self, idx: int) -> Tuple[int, Dict[str, np.ndarray]]:
        """(camera index, {"image": float32 (H, W, C)}) of an eval view (reference :379-381)."""
        return idx, {"image": self.eval_dataset.get_image_float32(idx)}


class FullImageDatamanager:
    """Full-image batches for splatfacto (reference ``FullImageDatamanager``,
    datamanagers.py:387-442): the train images live on the device, the
    cameras on the host (the projection reads them there), and the camera
    order comes from a host ``np.random.default_rng(seed)``, redrawn each
    epoch, the same draw as the reference's for the same seed: a
    permutation, or with ``camera_sampling="fps"`` a greedy farthest-point
    order over the camera positions from a random first one. Masks are
    read and not used, as in the reference."""

    def __init__(self, cameras: Cameras, images: torch.Tensor, eval_cameras: Optional[Cameras] = None,
                 eval_images: Optional[torch.Tensor] = None, seed: int = 0, device=None,
                 camera_sampling: str = "random"):
        if images.ndim != 4:
            raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
        device = resolve_device(device)
        self.camera_sampling = camera_sampling
        self.train_cameras = cameras.to("cpu")
        self.train_images = images.to(device)
        self.eval_cameras = self.train_cameras if eval_cameras is None else eval_cameras.to("cpu")
        self.eval_images = self.train_images if eval_images is None else eval_images.to(device)
        self._rng = np.random.default_rng(seed)
        self._perm = self._next_order()
        self._cursor = 0
        self.train_dataset = self.eval_dataset = None

    @classmethod
    def from_datasets(cls, config: DataManagerConfig, train_dataset: InputDataset,
                      eval_dataset: Optional[InputDataset] = None, device=None) -> "FullImageDatamanager":
        """The train split's uint8 images, undistorted on the host where its
        cameras carry distortion (which the train cameras then lose), and
        the eval split's float32 ones (alpha blended as
        ``InputDataset.get_image_float32`` blends it), each uploaded once,
        the camera order from seed 0 (reference :394-431)."""
        eval_dataset = eval_dataset or train_dataset
        eval_images = np.stack([eval_dataset.get_image_float32(i) for i in range(len(eval_dataset))])
        images, cameras = maybe_undistort_dataset(train_dataset.load_all()["images"], train_dataset.cameras)
        dm = cls(cameras, torch.from_numpy(images), eval_dataset.cameras, torch.from_numpy(eval_images), seed=0,
                 device=device, camera_sampling=config.camera_sampling)
        dm.train_dataset, dm.eval_dataset = train_dataset, eval_dataset
        return dm

    def _next_order(self) -> np.ndarray:
        """One epoch's camera order (reference :418-431)."""
        n = self.train_cameras.camera_to_worlds.shape[0]
        if self.camera_sampling != "fps" or n <= 2:
            return self._rng.permutation(n)
        pos = self.train_cameras.camera_to_worlds[:, :3, 3].numpy()
        order = [int(self._rng.integers(n))]
        d = np.linalg.norm(pos - pos[order[0]], axis=-1)
        for _ in range(n - 1):
            nxt = int(np.argmax(d))
            order.append(nxt)
            d = np.minimum(d, np.linalg.norm(pos - pos[nxt], axis=-1))
        return np.asarray(order)

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
            self._perm = self._next_order()
            self._cursor = 0
        idx = int(self._perm[self._cursor])
        self._cursor += 1
        return idx, _as_float(self.train_images[idx])

    def eval_image(self, idx: int) -> torch.Tensor:
        return _as_float(self.eval_images[idx])


def _as_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 images looked up in ``_unit_table`` (the CPU's quotients on
    every device, as ``gather_pixels`` does); float32 ones as they are."""
    return _unit_table(img.device)[img.long()] if img.dtype == torch.uint8 else img
