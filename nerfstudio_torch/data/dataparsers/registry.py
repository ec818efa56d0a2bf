"""Dataparser registry: name -> config class (counterpart of
``nerfstudio_tpu/data/dataparsers/registry.py``), for the CLI's
``--dataparser NAME``. The nerfstudio and Blender parsers are ported; every
other name of the reference's registry raises."""

from __future__ import annotations

from typing import Dict, Type

from nerfstudio_torch.data.dataparsers.base_dataparser import DataParserConfig
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig

DATAPARSERS: Dict[str, Type[DataParserConfig]] = {
    "nerfstudio-data": NerfstudioDataParserConfig,
    "blender-data": BlenderDataParserConfig,
}
# the reference's other parsers (its built-ins and specialty parsers)
NOT_PORTED = ("colmap", "instant-ngp-data", "minimal-parser", "dnerf-data", "phototourism-data", "sdfstudio-data",
              "scannet-data", "scannetpp-data", "arkitscenes-data", "nuscenes-data", "nerfosr-data", "dycheck-data",
              "sitcoms3d-data")


def get_dataparser_config(name: str) -> DataParserConfig:
    """A fresh config of the parser ``name`` (or its short alias without
    ``-data``)."""
    for key in (name, f"{name}-data"):
        if key in DATAPARSERS:
            return DATAPARSERS[key]()
        if key in NOT_PORTED:
            raise NotImplementedError(f"dataparser {key!r} is not ported yet (ROADMAP queue 1 item 13)")
    raise KeyError(f"unknown dataparser {name!r}; ported: {sorted(DATAPARSERS)}")
