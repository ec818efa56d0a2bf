"""COLMAP dataparser (counterpart of
``nerfstudio_tpu/data/dataparsers/colmap_dataparser.py``).

Reads a sparse reconstruction (binary or text, ``colmap_parsing_utils``),
turns each image's world-to-camera pose into an OpenGL camera-to-world,
orients and centres the poses ("up", "pca", "vertical" or "none";
"poses", "focus" or "none"), scales them into the unit cube, splits the
images (every ``eval_interval``-th held out, a fraction, or all) and reads
the intrinsics and distortion of the camera models the reference reads,
their types through ``CAMERA_MODEL_TO_TYPE``. The 3D points, moved into
the poses' frame, go into ``metadata`` (``points3D_xyz``, ``points3D_rgb``,
``points3D_error``): splatfacto seeds from them. Host-side numpy in the
reference's order of operations, then float32 tensors on the CPU."""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from nerfstudio_torch.cameras import camera_utils
from nerfstudio_torch.cameras.cameras import CAMERA_MODEL_TO_TYPE, Cameras, CameraType
from nerfstudio_torch.data.dataparsers.base_dataparser import DataParser, DataParserConfig, DataparserOutputs
from nerfstudio_torch.data.dataparsers.colmap_parsing_utils import qvec2rotmat, read_model
from nerfstudio_torch.data.scene_box import SceneBox


@dataclasses.dataclass
class ColmapDataParserConfig(DataParserConfig):
    """(reference colmap_dataparser.py:27-47): the same fields and defaults."""

    data: Path = Path()
    colmap_path: Path = Path("colmap/sparse/0")
    images_path: Path = Path("images")
    masks_path: Optional[Path] = None
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: Literal["pca", "up", "vertical", "none"] = "up"
    center_method: Literal["poses", "focus", "none"] = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    eval_mode: Literal["fraction", "interval", "all"] = "interval"
    eval_interval: int = 8
    load_3D_points: bool = True
    max_2D_matches_per_3D_point: int = 0

    def setup(self) -> "ColmapDataParser":
        return ColmapDataParser(config=self)


def _intrinsics(model: str, params: np.ndarray):
    """(fx, fy, cx, cy, the packed distortion) of a COLMAP camera model
    (reference :66-94); any other model raises."""
    if model == "SIMPLE_PINHOLE":
        return params[0], params[0], params[1], params[2], camera_utils.get_distortion_params()
    if model == "PINHOLE":
        return (*params[:4], camera_utils.get_distortion_params())
    if model == "SIMPLE_RADIAL":
        return params[0], params[0], params[1], params[2], camera_utils.get_distortion_params(k1=params[3])
    if model == "RADIAL":
        return (params[0], params[0], params[1], params[2],
                camera_utils.get_distortion_params(k1=params[3], k2=params[4]))
    if model == "OPENCV":
        return (*params[:4], camera_utils.get_distortion_params(k1=params[4], k2=params[5], p1=params[6],
                                                                p2=params[7]))
    if model == "OPENCV_FISHEYE":
        return (*params[:4], camera_utils.get_distortion_params(k1=params[4], k2=params[5], k3=params[6],
                                                                k4=params[7]))
    raise NotImplementedError(f"camera model {model}")


@dataclasses.dataclass
class ColmapDataParser(DataParser):
    """(reference colmap_dataparser.py:50-170)"""

    config: ColmapDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        cfg = self.config
        data_dir = Path(cfg.data)
        cameras_raw, images_raw, (pts_xyz, pts_rgb, pts_err) = read_model(data_dir / cfg.colmap_path)

        image_filenames, poses = [], []
        fx, fy, cx, cy, h, w, distort, cam_types = [], [], [], [], [], [], [], []
        for im in sorted(images_raw.values(), key=lambda im: im.name):
            cam = cameras_raw[im.camera_id]
            w2c = np.concatenate([np.concatenate([qvec2rotmat(im.qvec), im.tvec.reshape(3, 1)], 1),
                                  [[0, 0, 0, 1]]], 0)
            c2w = np.linalg.inv(w2c)
            c2w[0:3, 1:3] *= -1  # COLMAP (OpenCV) -> OpenGL: flip the y and z axes
            poses.append(c2w[:3].astype(np.float32))
            image_filenames.append(data_dir / cfg.images_path / im.name)
            fxi, fyi, cxi, cyi, d = _intrinsics(cam.model, cam.params)
            fx.append(fxi)
            fy.append(fyi)
            cx.append(cxi)
            cy.append(cyi)
            h.append(cam.height)
            w.append(cam.width)
            distort.append(d)
            cam_types.append(CAMERA_MODEL_TO_TYPE.get(cam.model, CameraType.PERSPECTIVE).value)

        poses, transform = camera_utils.auto_orient_and_center_poses(
            np.stack(poses), method=cfg.orientation_method, center_method=cfg.center_method)
        poses = poses[:, :3]
        scale = 1.0
        if cfg.auto_scale_poses:
            scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
        scale *= cfg.scale_factor
        poses[:, :3, 3] *= scale

        idx_all = np.arange(len(image_filenames))
        if cfg.eval_mode == "interval":
            eval_idx = idx_all[:: cfg.eval_interval]
            train_idx = np.setdiff1d(idx_all, eval_idx)
        elif cfg.eval_mode == "fraction":
            train_idx = np.linspace(0, len(idx_all) - 1, math.ceil(len(idx_all) * cfg.train_split_fraction),
                                    dtype=np.int64)
            eval_idx = np.setdiff1d(idx_all, train_idx)
        else:
            train_idx = eval_idx = idx_all
        indices = train_idx if split == "train" else eval_idx

        df = cfg.downscale_factor or 1
        cameras = Cameras.create(
            camera_to_worlds=poses[indices],
            fx=np.asarray(fx, np.float32)[indices] / df, fy=np.asarray(fy, np.float32)[indices] / df,
            cx=np.asarray(cx, np.float32)[indices] / df, cy=np.asarray(cy, np.float32)[indices] / df,
            width=np.asarray(w, np.int32)[indices] // df, height=np.asarray(h, np.int32)[indices] // df,
            distortion_params=np.stack(distort)[indices], camera_type=np.asarray(cam_types, np.int32)[indices],
            device="cpu")

        ss = cfg.scene_scale
        metadata = {}
        if cfg.load_3D_points and len(pts_xyz):
            pts_h = np.concatenate([pts_xyz, np.ones_like(pts_xyz[:, :1])], axis=-1)
            pts_w = (transform @ pts_h[..., None])[..., 0] * scale
            metadata["points3D_xyz"] = torch.from_numpy(np.asarray(pts_w, dtype=np.float32))
            metadata["points3D_rgb"] = torch.from_numpy(np.array(pts_rgb, copy=True))
            metadata["points3D_error"] = torch.from_numpy(np.asarray(pts_err, dtype=np.float32))

        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in indices],
            cameras=cameras,
            scene_box=SceneBox(aabb=torch.tensor([[-ss, -ss, -ss], [ss, ss, ss]], dtype=torch.float32)),
            dataparser_transform=np.asarray(transform, np.float32)[:3],
            dataparser_scale=scale,
            metadata=metadata,
        )
