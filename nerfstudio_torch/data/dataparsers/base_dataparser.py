"""Dataparser base (counterpart of
``nerfstudio_tpu/data/dataparsers/base_dataparser.py``).

A DataParser reads a capture from disk (host-side numpy) and returns
DataparserOutputs: filenames, the cameras (on the CPU: the datamanagers
move them to their device), the scene bounds and metadata (splatfacto's
seed points, the depth files and the semantic labels live there)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.scene_box import SceneBox


@dataclasses.dataclass
class Semantics:
    """Semantic label info (reference base_dataparser.py:22-28): a label
    image per frame, the class names and a colour per class."""

    filenames: List[Path]
    classes: List[str]
    colors: np.ndarray
    mask_classes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DataparserOutputs:
    """(reference base_dataparser.py:31-62)"""

    image_filenames: List[Path]
    cameras: Cameras
    alpha_color: Optional[torch.Tensor] = None
    scene_box: SceneBox = dataclasses.field(
        default_factory=lambda: SceneBox(aabb=torch.tensor([[-1.0, -1, -1], [1.0, 1, 1]]))
    )
    mask_filenames: Optional[List[Path]] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dataparser_transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4)[:3].astype(np.float32))
    dataparser_scale: float = 1.0

    def save_dataparser_transform(self, path: Path) -> None:
        """Persist the transform for downstream tools (reference :51-62)."""
        data = {"transform": np.asarray(self.dataparser_transform).tolist(), "scale": float(self.dataparser_scale)}
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=4)


@dataclasses.dataclass
class DataParserConfig:
    """(reference base_dataparser.py:82-89)"""

    data: Path = Path()

    def setup(self) -> "DataParser":
        raise NotImplementedError


@dataclasses.dataclass
class DataParser:
    """(reference base_dataparser.py:92-101)"""

    config: DataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        raise NotImplementedError

    def get_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        return self._generate_dataparser_outputs(split, **kwargs)
