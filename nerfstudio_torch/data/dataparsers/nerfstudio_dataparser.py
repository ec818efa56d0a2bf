"""Nerfstudio-format (transforms.json) dataparser (counterpart of
``nerfstudio_tpu/data/dataparsers/nerfstudio_dataparser.py``).

Every camera model of the reference's ``CAMERA_MODEL_TO_TYPE`` (any other
name is perspective), global or per-frame intrinsics and distortion (a
frame without distortion keys gets zeros, as in the reference; a
``distortion_params`` list of 12 for Fisheye624), per-frame masks
(``mask_path``), depth maps (``depth_file_path``, in units of
``depth_unit_scale_factor``) and semantic label images (``semantic_path``,
with the capture's ``semantic_classes``, else 256 numbered classes), the
"up"/"pca"/"vertical" orientation with centring, auto pose scaling, the
fraction, interval and all eval splits, downscale factors, and the ply seed
points (splatfacto's init, depth-nerfacto's SfM depth). The poses are
numpy float32 through the reference's numpy math, then a float32 tensor.
Not ported: the filename split."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from nerfstudio_torch.cameras import camera_utils
from nerfstudio_torch.cameras.cameras import CAMERA_MODEL_TO_TYPE, Cameras, CameraType
from nerfstudio_torch.data.dataparsers.base_dataparser import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    Semantics,
)
from nerfstudio_torch.data.scene_box import SceneBox

MAX_AUTO_RESOLUTION = 1600


@dataclasses.dataclass
class NerfstudioDataParserConfig(DataParserConfig):
    data: Path = Path()
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: Literal["pca", "up", "vertical", "none"] = "up"
    center_method: Literal["poses", "focus", "none"] = "poses"
    auto_scale_poses: bool = True
    eval_mode: Literal["fraction", "filename", "interval", "all"] = "fraction"
    train_split_fraction: float = 0.9
    eval_interval: int = 8
    depth_unit_scale_factor: float = 1e-3
    load_3D_points: bool = False

    def setup(self) -> "Nerfstudio":
        return Nerfstudio(config=self)


@dataclasses.dataclass
class Nerfstudio(DataParser):
    config: NerfstudioDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        cfg = self.config
        data = Path(cfg.data)
        meta_path = data / "transforms.json" if data.is_dir() else data
        data_dir = meta_path.parent
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        image_filenames, mask_filenames, depth_filenames, semantic_filenames, poses = [], [], [], [], []
        fx, fy, cx, cy, height, width, distort = [], [], [], [], [], [], []
        distort_fixed = any(k in meta for k in ("k1", "k2", "k3", "p1", "p2", "distortion_params"))

        def get_distort(src) -> np.ndarray:
            if "distortion_params" in src:
                return np.asarray(src["distortion_params"], dtype=np.float32)
            return camera_utils.get_distortion_params(
                k1=float(src.get("k1", 0)), k2=float(src.get("k2", 0)), k3=float(src.get("k3", 0)),
                k4=float(src.get("k4", 0)), p1=float(src.get("p1", 0)), p2=float(src.get("p2", 0)),
            )

        frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
        per_frame_files = ((mask_filenames, "mask_path"), (depth_filenames, "depth_file_path"),
                           (semantic_filenames, "semantic_path"))
        for frame in frames:
            image_filenames.append(data_dir / frame["file_path"])
            for lst, key in per_frame_files:
                if key in frame:
                    lst.append(data_dir / frame[key])
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
            for lst, key, typ in ((fx, "fl_x", float), (fy, "fl_y", float), (cx, "cx", float), (cy, "cy", float),
                                  (height, "h", int), (width, "w", int)):
                if key not in meta:
                    lst.append(typ(frame[key]))
            if not distort_fixed:
                distort.append(get_distort(frame))
        for lst, key in per_frame_files:
            if len(lst) not in (0, len(image_filenames)):
                raise ValueError(f"{len(lst)} of {len(image_filenames)} frames have a {key}: all or none")

        # train/eval split (reference :119-136)
        num_images = len(image_filenames)
        idx = np.arange(num_images)
        if cfg.eval_mode == "fraction":
            num_train = math.ceil(num_images * cfg.train_split_fraction)
            train_idx = np.linspace(0, num_images - 1, num_train, dtype=np.int64)
            eval_idx = np.setdiff1d(idx, train_idx)
        elif cfg.eval_mode == "interval":
            eval_idx = idx[:: cfg.eval_interval]
            train_idx = np.setdiff1d(idx, eval_idx)
        elif cfg.eval_mode == "all":
            train_idx = eval_idx = idx
        else:
            raise NotImplementedError(cfg.eval_mode)
        if eval_idx.size == 0:
            # tiny captures: ceil(n * fraction) can take every image; evaluate
            # on the last frame, as the reference does
            eval_idx = idx[-1:]
        indices = train_idx if split == "train" else eval_idx

        # OpenGL c2w; the ply points are not pre-transformed, so the
        # applied_transform joins the dataparser transform (reference :138-160)
        poses = np.stack(poses, axis=0)
        applied = meta.get("applied_transform")
        if applied is None and (data_dir / "colmap" / "sparse" / "0").exists():
            applied = [[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, -1, 0]]
        poses, transform_matrix = camera_utils.auto_orient_and_center_poses(
            poses, method=cfg.orientation_method, center_method=cfg.center_method
        )
        poses = poses[:, :3]
        if applied is not None:
            a44 = np.eye(4, dtype=np.float32)
            a44[:3] = np.asarray(applied, dtype=np.float32)[:3]
            t44 = np.eye(4, dtype=np.float32)
            t44[:3] = np.asarray(transform_matrix, dtype=np.float32)[:3]
            transform_matrix = (t44 @ a44)[:3]
        scale = 1.0
        if cfg.auto_scale_poses:
            scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
        scale *= cfg.scale_factor
        poses[:, :3, 3] *= scale

        s = cfg.scene_scale
        scene_box = SceneBox(aabb=torch.tensor([[-s, -s, -s], [s, s, s]], dtype=torch.float32))

        def pick(lst, key):
            if key in meta:
                return np.full(len(indices), float(meta[key]), dtype=np.float32)
            return np.asarray(lst, dtype=np.float32)[indices]

        fx_arr, fy_arr, cx_arr, cy_arr = (pick(v, k) for v, k in ((fx, "fl_x"), (fy, "fl_y"), (cx, "cx"), (cy, "cy")))
        if "h" in meta:
            h_arr = np.full(len(indices), int(meta["h"]), dtype=np.int32)
            w_arr = np.full(len(indices), int(meta["w"]), dtype=np.int32)
        else:
            h_arr = np.asarray(height, dtype=np.int32)[indices]
            w_arr = np.asarray(width, dtype=np.int32)[indices]
        if distort_fixed:
            d_arr = np.tile(get_distort(meta), (len(indices), 1))
        elif distort:
            d_arr = np.stack(distort, axis=0)[indices]
        else:
            d_arr = None
        cam_type = CAMERA_MODEL_TO_TYPE.get(meta.get("camera_model", "OPENCV"), CameraType.PERSPECTIVE)

        df = cfg.downscale_factor
        if df is None:
            max_side = int(max(h_arr.max(), w_arr.max()))
            df = 1
            while max_side // (2 * df) > MAX_AUTO_RESOLUTION:
                df *= 2
        if df > 1:
            image_filenames = [
                data_dir / f"images_{df}" / Path(p).name if (data_dir / f"images_{df}" / Path(p).name).exists() else p
                for p in image_filenames
            ]
            fx_arr, fy_arr = fx_arr / df, fy_arr / df
            cx_arr, cy_arr = cx_arr / df, cy_arr / df
            h_arr, w_arr = h_arr // df, w_arr // df

        cameras = Cameras.create(
            camera_to_worlds=poses[indices], fx=fx_arr, fy=fy_arr, cx=cx_arr, cy=cy_arr, width=w_arr, height=h_arr,
            distortion_params=d_arr, camera_type=cam_type, device="cpu",
        )
        metadata = {
            "depth_filenames": [depth_filenames[i] for i in indices] if depth_filenames else None,
            "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
        }
        if semantic_filenames:  # the reference's classes and colours (:225-240)
            classes = list(meta.get("semantic_classes", [])) or [f"class_{i}" for i in range(256)]
            metadata["semantics"] = Semantics(
                filenames=[semantic_filenames[i] for i in indices], classes=classes,
                colors=np.random.default_rng(0).uniform(size=(len(classes), 3)).astype(np.float32))
        if cfg.load_3D_points:
            ply_path = meta.get("ply_file_path")
            if ply_path is not None and (data_dir / ply_path).exists():
                from nerfstudio_torch.exporter.ply_io import read_ply

                pts, rgb = read_ply(data_dir / ply_path)
                pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
                pts = (transform_matrix @ pts_h[..., None])[..., 0] * scale
                metadata["points3D_xyz"] = torch.from_numpy(np.asarray(pts, dtype=np.float32))
                metadata["points3D_rgb"] = None if rgb is None else torch.from_numpy(rgb)

        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in indices],
            cameras=cameras,
            scene_box=scene_box,
            mask_filenames=[mask_filenames[i] for i in indices] if mask_filenames else None,
            dataparser_transform=np.asarray(transform_matrix, dtype=np.float32)[:3],
            dataparser_scale=scale,
            metadata=metadata,
        )
