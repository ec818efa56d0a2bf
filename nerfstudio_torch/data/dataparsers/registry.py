"""Dataparser registry: name -> config class (counterpart of
``nerfstudio_tpu/data/dataparsers/registry.py``), for the CLI's
``--dataparser NAME``: every parser of the reference's registry, its
built-ins and its specialty parsers, and the parsers plugins register,
each also under its short alias without ``-data``."""

from __future__ import annotations

from typing import Dict, Type

from nerfstudio_torch.data.dataparsers.base_dataparser import DataParserConfig
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.data.dataparsers.colmap_dataparser import ColmapDataParserConfig
from nerfstudio_torch.data.dataparsers.extra_dataparsers import (
    DNeRFDataParserConfig,
    InstantNGPDataParserConfig,
    MinimalDataParserConfig,
    PhototourismDataParserConfig,
    SDFStudioDataParserConfig,
)
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.data.dataparsers.specialty_dataparsers import SPECIALTY_PARSERS

DATAPARSERS: Dict[str, Type[DataParserConfig]] = {
    "nerfstudio-data": NerfstudioDataParserConfig,
    "blender-data": BlenderDataParserConfig,
    "colmap": ColmapDataParserConfig,
    "instant-ngp-data": InstantNGPDataParserConfig,
    "minimal-parser": MinimalDataParserConfig,
    "dnerf-data": DNeRFDataParserConfig,
    "phototourism-data": PhototourismDataParserConfig,
    "sdfstudio-data": SDFStudioDataParserConfig,
    **SPECIALTY_PARSERS,
}


def dataparser_registry() -> Dict[str, Type[DataParserConfig]]:
    """The built-in parsers, the ones plugins register
    (``plugins.discover_dataparsers``; reference registry.py:46-48), and
    each ``-data`` name's short alias."""
    from nerfstudio_torch.plugins import discover_dataparsers

    reg = {**DATAPARSERS, **discover_dataparsers()}
    aliases = {name.removesuffix("-data"): cfg for name, cfg in reg.items() if name.endswith("-data")}
    return {**aliases, **reg}


def get_dataparser_config(name: str) -> DataParserConfig:
    """A fresh config of the parser ``name`` (or its short alias without
    ``-data``)."""
    reg = dataparser_registry()
    if name not in reg:
        raise KeyError(f"unknown dataparser {name!r}; available: {sorted(reg)}")
    return reg[name]()
