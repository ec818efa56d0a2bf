"""Datasets: a split's images from disk, on the host (counterpart of
``InputDataset`` in ``nerfstudio_tpu/data/datasets.py``).

Images decode through ``data/image_io`` (PNG with zlib and a host routine
for the row filters, JPEG through Pillow where it imports) to uint8, then float32 in [0, 1] with the
alpha blended over the dataparser's ``alpha_color`` as the reference does.
Masks decode through the same reader and keep their first channel, > 127
valid. ``load_all`` stacks the split (and its masks) for the datamanagers,
which upload it to the device once; ``load_all_bucketed`` groups a
mixed-resolution split into one stack per resolution. Resizing by
``scale_factor``, the C++ batch loader and the depth, semantic and SDF
datasets are not ported."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from nerfstudio_torch.data.dataparsers.base_dataparser import DataparserOutputs
from nerfstudio_torch.data.image_io import read_image


class InputDataset:
    """(reference datasets.py:18-87)"""

    def __init__(self, dataparser_outputs: DataparserOutputs, scale_factor: float = 1.0):
        if scale_factor != 1.0:
            raise NotImplementedError("resizing a dataset's images (scale_factor != 1) is not ported")
        self._dataparser_outputs = dataparser_outputs
        self.scale_factor = scale_factor
        self.scene_box = dataparser_outputs.scene_box
        self.metadata = dataparser_outputs.metadata
        self.cameras = dataparser_outputs.cameras

    def __len__(self) -> int:
        return len(self._dataparser_outputs.image_filenames)

    @property
    def alpha_color(self):
        return self._dataparser_outputs.alpha_color

    def get_numpy_image(self, image_idx: int) -> np.ndarray:
        """uint8 (H, W, C) image; grey becomes three channels (reference :36-51)."""
        image = read_image(self._dataparser_outputs.image_filenames[image_idx])
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        return image

    def get_image_float32(self, image_idx: int) -> np.ndarray:
        """float32 [0, 1] RGB with the alpha blended (reference :53-64)."""
        image = self.get_numpy_image(image_idx).astype(np.float32) / 255.0
        alpha_color = self._dataparser_outputs.alpha_color
        if image.shape[-1] == 4:
            if alpha_color is not None:
                image = image[..., :3] * image[..., 3:] + np.asarray(alpha_color) * (1.0 - image[..., 3:])
            else:
                image = image[..., :3] * image[..., 3:]
        return image

    def get_mask(self, image_idx: int) -> Optional[np.ndarray]:
        """(H, W, 1) bool: the mask's first channel > 127; None without masks
        (reference :68-76)."""
        if self._dataparser_outputs.mask_filenames is None:
            return None
        return (read_image(self._dataparser_outputs.mask_filenames[image_idx])[..., 0] > 127)[..., None]

    def load_all(self) -> Dict[str, np.ndarray]:
        """The whole split as one uint8 stack (N, H, W, C), and its masks
        (N, H, W, 1) where the split has them (reference :119-141); images of
        different sizes raise ``ValueError``: ``load_all_bucketed`` takes
        them."""
        images = [self.get_numpy_image(i) for i in range(len(self))]
        shapes = {im.shape for im in images}
        if len(shapes) != 1:
            raise ValueError(f"variable resolutions {shapes}: use load_all_bucketed() "
                             "(the datamanager does this automatically)")
        out = {"images": np.stack(images, axis=0)}
        if self._dataparser_outputs.mask_filenames is not None:
            out["masks"] = np.stack([self.get_mask(i) for i in range(len(self))], axis=0)
        return out

    def load_all_bucketed(self) -> List[Dict[str, np.ndarray]]:
        """A mixed-resolution split as one stack per exact (H, W, C), largest
        bucket (images times pixels) first (reference :142-193): each
        ``{"images": (B, H, W, C) uint8, "camera_indices": (B,) int32[,
        "masks": (B, H, W, 1) bool]}``."""
        images = [self.get_numpy_image(i) for i in range(len(self))]
        has_masks = self._dataparser_outputs.mask_filenames is not None
        buckets: Dict[tuple, List[int]] = {}
        for i, im in enumerate(images):
            buckets.setdefault(im.shape, []).append(i)
        out = []
        for _, idxs in sorted(buckets.items(), key=lambda kv: -len(kv[1]) * kv[0][0] * kv[0][1]):
            b = {"images": np.stack([images[i] for i in idxs], axis=0), "camera_indices": np.asarray(idxs, np.int32)}
            if has_masks:
                b["masks"] = np.stack([self.get_mask(i) for i in idxs], axis=0)
            out.append(b)
        return out
