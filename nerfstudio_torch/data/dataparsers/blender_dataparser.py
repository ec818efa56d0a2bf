"""Blender synthetic dataset parser (counterpart of
``nerfstudio_tpu/data/dataparsers/blender_dataparser.py``): reads
``transforms_{split}.json`` (camera_angle_x and per-frame c2w), the scene
box [-1.5, 1.5]^3, an optional alpha colour and ``points3D.ply`` seed
points beside the json."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerfstudio_torch.cameras.cameras import Cameras, CameraType
from nerfstudio_torch.data.dataparsers.base_dataparser import DataParser, DataParserConfig, DataparserOutputs
from nerfstudio_torch.data.image_io import image_size
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.utils.colors import get_color


@dataclasses.dataclass
class BlenderDataParserConfig(DataParserConfig):
    data: Path = Path("data/blender/lego")
    scale_factor: float = 1.0
    alpha_color: Optional[str] = "white"
    ply_path: Optional[Path] = None

    def setup(self) -> "Blender":
        return Blender(config=self)


@dataclasses.dataclass
class Blender(DataParser):
    config: BlenderDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data_dir = Path(self.config.data)
        with open(data_dir / f"transforms_{split}.json", encoding="utf-8") as f:
            meta = json.load(f)

        image_filenames, poses = [], []
        for frame in meta["frames"]:
            fname = data_dir / Path(frame["file_path"].replace("./", "") + ".png")
            if not fname.exists():
                fname = data_dir / Path(frame["file_path"].replace("./", ""))
            image_filenames.append(fname)
            poses.append(np.array(frame["transform_matrix"], dtype=np.float32))
        poses = np.stack(poses, axis=0)

        image_width, image_height = image_size(image_filenames[0])
        camera_angle_x = float(meta["camera_angle_x"])
        focal_length = 0.5 * image_width / np.tan(0.5 * camera_angle_x)
        poses[:, :3, 3] *= self.config.scale_factor

        cameras = Cameras.create(
            camera_to_worlds=poses[:, :3], fx=focal_length, fy=focal_length, cx=image_width / 2.0,
            cy=image_height / 2.0, width=image_width, height=image_height, camera_type=CameraType.PERSPECTIVE,
            device="cpu",
        )
        alpha_color = get_color(self.config.alpha_color) if self.config.alpha_color is not None else None

        metadata = {}
        ply_path = self.config.ply_path
        if ply_path is None and (data_dir / "points3D.ply").exists():
            # seed points written next to the json (tools/make_synthetic_dataset.py)
            ply_path = data_dir / "points3D.ply"
        if ply_path is not None:
            from nerfstudio_torch.exporter.ply_io import read_ply

            pts, colors = read_ply(Path(ply_path))
            metadata["points3D_xyz"] = torch.from_numpy(pts)
            metadata["points3D_rgb"] = None if colors is None else torch.from_numpy(colors)

        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            alpha_color=alpha_color,
            scene_box=SceneBox(aabb=torch.tensor([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])),
            dataparser_scale=self.config.scale_factor,
            metadata=metadata,
        )
