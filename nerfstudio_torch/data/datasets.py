"""Datasets: a split's images from disk, on the host (counterpart of
``InputDataset``, ``DepthDataset`` and ``SemanticDataset`` in
``nerfstudio_tpu/data/datasets.py``).

Images decode through ``data/image_io`` (PNG with zlib and a host routine
for the row filters, JPEG through Pillow where it imports) to uint8, then float32 in [0, 1] with the
alpha blended over the dataparser's ``alpha_color`` as the reference does.
Masks decode through the same reader and keep their first channel, > 127
valid. ``load_all`` stacks the split (and its masks) for the datamanagers,
which upload it to the device once; ``load_all_bucketed`` groups a
mixed-resolution split into one stack per resolution (with its depth maps
where the dataset has them). ``DepthDataset`` reads a depth map per image
(``.npy`` or PNG, 16-bit grey included, times ``depth_unit_scale_factor``)
or, without depth files, projects the parser's SfM points into each camera;
``SemanticDataset`` reads each image's class labels. Resizing by
``scale_factor``, the C++ batch loader and the SDF dataset are not
ported."""

from __future__ import annotations

from pathlib import Path
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

    def get_metadata(self, image_idx: int) -> Dict:
        """The image's per-pixel supervision beside its colours: none here."""
        return {}

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
        "masks": (B, H, W, 1) bool][, "depths": (B, H, W, 1) float32]}``,
        depths where the dataset provides them."""
        images = [self.get_numpy_image(i) for i in range(len(self))]
        has_masks = self._dataparser_outputs.mask_filenames is not None
        has_depth = getattr(self, "provides_depth", False)
        buckets: Dict[tuple, List[int]] = {}
        for i, im in enumerate(images):
            buckets.setdefault(im.shape, []).append(i)
        out = []
        for _, idxs in sorted(buckets.items(), key=lambda kv: -len(kv[1]) * kv[0][0] * kv[0][1]):
            b = {"images": np.stack([images[i] for i in idxs], axis=0), "camera_indices": np.asarray(idxs, np.int32)}
            if has_masks:
                b["masks"] = np.stack([self.get_mask(i) for i in idxs], axis=0)
            if has_depth:
                b["depths"] = np.stack([self.get_metadata(i)["depth_image"] for i in idxs], axis=0).astype(np.float32)
            out.append(b)
        return out


class DepthDataset(InputDataset):
    """Per-image depth maps (reference datasets.py:186-268). Without depth
    files the parser's SfM points (``points3D_xyz``, in the model's frame)
    are projected into each camera: sparse, exact termination depths, 0
    where no point lands (the depth losses skip depth 0). Upstream
    nerfstudio draws dense pseudo-depth from a pretrained network there;
    the JAX package, which runs offline, projects the points instead."""

    def __init__(self, dataparser_outputs: DataparserOutputs, scale_factor: float = 1.0):
        super().__init__(dataparser_outputs, scale_factor)
        self.depth_filenames = dataparser_outputs.metadata.get("depth_filenames")
        self.depth_unit_scale_factor = dataparser_outputs.metadata.get("depth_unit_scale_factor", 1e-3)
        self._sfm_points = None
        if not self.depth_filenames:
            pts = dataparser_outputs.metadata.get("points3D_xyz")
            if pts is not None and len(pts):
                self._sfm_points = np.asarray(pts, np.float32)
                print(f"[depth-dataset] no depth files: projecting {len(self._sfm_points)} SfM points into each "
                      "camera for sparse depth supervision", flush=True)
            else:
                print("[depth-dataset] WARNING: no depth files and no SfM points: depth supervision disabled "
                      "(give each frame a depth_file_path, or seed points with load_3D_points)", flush=True)

    @property
    def provides_depth(self) -> bool:
        return bool(self.depth_filenames) or self._sfm_points is not None

    def _sfm_depth_map(self, image_idx: int) -> np.ndarray:
        """(H, W, 1) float32 z-depth: each SfM point at its nearest pixel,
        the nearest point where several land on one pixel, 0 where none
        does (reference :233-255, the same numpy operations)."""
        cams = self.cameras
        c2w = cams.camera_to_worlds.numpy().reshape(-1, 3, 4)[image_idx]
        fx, fy, cx, cy = (float(v.reshape(-1)[image_idx]) for v in (cams.fx, cams.fy, cams.cx, cams.cy))
        h, w = (int(v.reshape(-1)[image_idx]) for v in (cams.height, cams.width))
        R, t = c2w[:3, :3], c2w[:3, 3]
        p_cam = (self._sfm_points - t) @ R  # world -> camera (OpenGL, -z forward)
        depth = -p_cam[:, 2]
        ok = depth > 1e-6
        a = p_cam[:, 0] / np.maximum(depth, 1e-6)
        b = p_cam[:, 1] / np.maximum(depth, 1e-6)
        col = np.round(a * fx + cx).astype(np.int64)
        row = np.round(cy - b * fy).astype(np.int64)
        ok &= (col >= 0) & (col < w) & (row >= 0) & (row < h)
        dm = np.full((h * w,), np.inf, np.float32)
        np.minimum.at(dm, row[ok] * w + col[ok], depth[ok])
        dm[~np.isfinite(dm)] = 0.0
        return dm.reshape(h, w, 1)

    def get_metadata(self, image_idx: int) -> Dict:
        """{"depth_image": (H, W, 1) float32} ({} without depth supervision)."""
        if not self.depth_filenames:
            return {} if self._sfm_points is None else {"depth_image": self._sfm_depth_map(image_idx)}
        path = Path(self.depth_filenames[image_idx])
        depth = np.load(path) if path.suffix == ".npy" else read_image(path).astype(np.float32)
        depth = depth * self.depth_unit_scale_factor
        if depth.ndim == 2:
            depth = depth[..., None]
        return {"depth_image": depth.astype(np.float32)}


class SemanticDataset(InputDataset):
    """Per-image class labels (reference datasets.py:271-297): the first
    channel of each label image, as int32 (H, W, 1). The sitcoms3d-style
    metadata keys of the reference belong to a parser that is not ported."""

    def __init__(self, dataparser_outputs: DataparserOutputs, scale_factor: float = 1.0):
        super().__init__(dataparser_outputs, scale_factor)
        self.semantics = (dataparser_outputs.metadata or {}).get("semantics")

    def get_metadata(self, image_idx: int) -> Dict:
        if self.semantics is None:
            return {}
        return {"semantics": read_image(self.semantics.filenames[image_idx])[..., :1].astype(np.int32)}
