"""The instant-ngp, minimal, D-NeRF, phototourism and sdfstudio parsers
(counterpart of ``nerfstudio_tpu/data/dataparsers/extra_dataparsers.py``),
each reading its capture format on the host into DataparserOutputs with
the cameras on the CPU:

* instant-ngp: ``transforms.json`` with global intrinsics (or field-of-view
  angles), OpenCV k1, k2, p1, p2, and ``aabb_scale``; poses offset by the
  format's 0.5 centre and scaled by ``scene_scale``;
* minimal: ``{split}.npz`` of cameras, filenames and an optional aabb;
* D-NeRF: the Blender format with a ``time`` per frame, which the cameras
  carry; white alpha, the scene box +-1.5, the image size read from the
  first PNG's header (no Pillow);
* phototourism: the COLMAP parser over ``dense/sparse`` and
  ``dense/images``, a fraction split (its ``scale_factor``,
  ``scene_scale`` and ``alpha_color`` are declared and not read, as in the
  reference);
* sdfstudio: ``meta_data.json`` with per-frame OpenCV poses and
  intrinsics, and with ``include_mono_prior`` the depth and normal priors'
  files (every frame in every split, as in the reference)."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from nerfstudio_torch.cameras import camera_utils
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.dataparsers.base_dataparser import DataParser, DataParserConfig, DataparserOutputs
from nerfstudio_torch.data.image_io import image_size
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.utils.colors import get_color


def _box(aabb) -> SceneBox:
    return SceneBox(aabb=torch.as_tensor(np.asarray(aabb, np.float32)))


@dataclasses.dataclass
class InstantNGPDataParserConfig(DataParserConfig):
    """(reference extra_dataparsers.py:33-40)"""

    data: Path = Path()
    scene_scale: float = 0.3333

    def setup(self) -> "InstantNGP":
        return InstantNGP(config=self)


@dataclasses.dataclass
class InstantNGP(DataParser):
    """(reference :43-100)"""

    config: InstantNGPDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        meta_path = data / "transforms.json" if data.is_dir() else data
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        image_filenames, poses = [], []
        for frame in meta["frames"]:
            fname = meta_path.parent / frame["file_path"]
            image_filenames.append(fname if fname.suffix else fname.with_suffix(".png"))
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
        poses = np.stack(poses)[:, :3]
        h, w = int(meta.get("h", 1080)), int(meta.get("w", 1920))
        if "fl_x" in meta:
            fl_x = float(meta["fl_x"])
            fl_y = float(meta.get("fl_y", fl_x))
        else:
            fl_x = 0.5 * w / math.tan(0.5 * float(meta["camera_angle_x"]))
            fl_y = 0.5 * h / math.tan(0.5 * float(meta["camera_angle_y"])) if "camera_angle_y" in meta else fl_x
        distort = camera_utils.get_distortion_params(k1=float(meta.get("k1", 0)), k2=float(meta.get("k2", 0)),
                                                     p1=float(meta.get("p1", 0)), p2=float(meta.get("p2", 0)))
        aabb_scale = float(meta.get("aabb_scale", 1))
        poses[:, :3, 3] = (poses[:, :3, 3] - 0.5) * self.config.scene_scale  # the format's 0.5 centre
        aabb = np.array([[-1, -1, -1], [1, 1, 1]], dtype=np.float32) * aabb_scale * self.config.scene_scale
        cameras = Cameras.create(poses, fl_x, fl_y, float(meta.get("cx", w / 2)), float(meta.get("cy", h / 2)), w, h,
                                 distortion_params=np.tile(distort, (len(poses), 1)), device="cpu")
        return DataparserOutputs(image_filenames=image_filenames, cameras=cameras, scene_box=_box(aabb),
                                 dataparser_scale=self.config.scene_scale)


@dataclasses.dataclass
class MinimalDataParserConfig(DataParserConfig):
    """(reference :102-108)"""

    data: Path = Path()

    def setup(self) -> "Minimal":
        return Minimal(config=self)


@dataclasses.dataclass
class Minimal(DataParser):
    """(reference :111-131)"""

    config: MinimalDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        d = np.load(Path(self.config.data) / f"{split}.npz", allow_pickle=True)
        f32 = lambda k: d[k].astype(np.float32)  # noqa: E731
        cameras = Cameras.create(f32("camera_to_worlds"), f32("fx"), f32("fy"), f32("cx"), f32("cy"),
                                 d["width"].astype(np.int32), d["height"].astype(np.int32), device="cpu")
        aabb = d["aabb"] if "aabb" in d else np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
        return DataparserOutputs(image_filenames=[Path(p) for p in d["image_filenames"]], cameras=cameras,
                                 scene_box=_box(aabb))


@dataclasses.dataclass
class DNeRFDataParserConfig(DataParserConfig):
    """(reference :139-147)"""

    data: Path = Path()
    scale_factor: float = 1.0
    alpha_color: str = "white"

    def setup(self) -> "DNeRF":
        return DNeRF(config=self)


@dataclasses.dataclass
class DNeRF(DataParser):
    """(reference :150-185)"""

    config: DNeRFDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data_dir = Path(self.config.data)
        with open(data_dir / f"transforms_{split}.json", encoding="utf-8") as f:
            meta = json.load(f)
        image_filenames, poses, times = [], [], []
        for frame in meta["frames"]:
            image_filenames.append(data_dir / Path(frame["file_path"].replace("./", "") + ".png"))
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
            times.append(float(frame.get("time", 0.0)))
        poses = np.stack(poses)
        w, h = image_size(image_filenames[0])
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        poses[:, :3, 3] *= self.config.scale_factor
        cameras = Cameras.create(poses[:, :3], focal, focal, w / 2, h / 2, w, h, device="cpu",
                                 times=np.asarray(times, np.float32))
        return DataparserOutputs(image_filenames=image_filenames, cameras=cameras,
                                 alpha_color=get_color(self.config.alpha_color),
                                 scene_box=_box([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]]),
                                 dataparser_scale=self.config.scale_factor)


@dataclasses.dataclass
class PhototourismDataParserConfig(DataParserConfig):
    """(reference :191-205)"""

    data: Path = Path()
    scale_factor: float = 3.0
    alpha_color: Optional[str] = None
    train_split_fraction: float = 0.9
    scene_scale: float = 1.0
    orientation_method: Literal["pca", "up", "vertical", "none"] = "up"
    center_method: Literal["poses", "focus", "none"] = "poses"
    auto_scale_poses: bool = True

    def setup(self) -> "Phototourism":
        return Phototourism(config=self)


@dataclasses.dataclass
class Phototourism(DataParser):
    """(reference :208-230)"""

    config: PhototourismDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        from nerfstudio_torch.data.dataparsers.colmap_dataparser import ColmapDataParserConfig

        cfg = self.config
        inner = ColmapDataParserConfig(
            data=cfg.data, colmap_path=Path("dense/sparse"), images_path=Path("dense/images"),
            orientation_method=cfg.orientation_method, center_method=cfg.center_method,
            auto_scale_poses=cfg.auto_scale_poses, train_split_fraction=cfg.train_split_fraction,
            eval_mode="fraction").setup()
        return inner.get_dataparser_outputs(split)


@dataclasses.dataclass
class SDFStudioDataParserConfig(DataParserConfig):
    """(reference :234-240)"""

    data: Path = Path()
    include_mono_prior: bool = False

    def setup(self) -> "SDFStudio":
        return SDFStudio(config=self)


@dataclasses.dataclass
class SDFStudio(DataParser):
    """(reference :243-285)"""

    config: SDFStudioDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data_dir = Path(self.config.data)
        with open(data_dir / "meta_data.json", encoding="utf-8") as f:
            meta = json.load(f)
        image_filenames, poses, depth_filenames, normal_filenames = [], [], [], []
        fx, fy, cx, cy = [], [], [], []
        for frame in meta["frames"]:
            image_filenames.append(data_dir / frame["rgb_path"])
            K = np.array(frame["intrinsics"], dtype=np.float32)
            poses.append(np.array(frame["camtoworld"], dtype=np.float32))
            fx.append(K[0, 0])
            fy.append(K[1, 1])
            cx.append(K[0, 2])
            cy.append(K[1, 2])
            if self.config.include_mono_prior:
                depth_filenames.append(data_dir / frame["mono_depth_path"])
                normal_filenames.append(data_dir / frame["mono_normal_path"])
        poses = np.stack(poses)
        poses[:, 0:3, 1:3] *= -1  # OpenCV -> OpenGL
        cameras = Cameras.create(poses[:, :3], np.asarray(fx), np.asarray(fy), np.asarray(cx), np.asarray(cy),
                                 int(meta["width"]), int(meta["height"]), device="cpu")
        bbox = np.array(meta.get("scene_box", {}).get("aabb", [[-1, -1, -1], [1, 1, 1]]))
        return DataparserOutputs(image_filenames=image_filenames, cameras=cameras, scene_box=_box(bbox),
                                 metadata={"depth_filenames": depth_filenames or None,
                                           "normal_filenames": normal_filenames or None})
