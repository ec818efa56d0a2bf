"""Dataparser registry: name -> config class (counterpart of
``nerfstudio_tpu/data/dataparsers/registry.py``), for the CLI's
``--dataparser NAME``. The nerfstudio and Blender parsers are ported; every
other name of the reference's registry raises, and so does a method config
that ships one of them (``UnportedDataParserConfig``) unless the user names
a ported parser."""

from __future__ import annotations

import dataclasses
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


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(f"dataparser {name!r} is not ported yet (ROADMAP queue 1 item 15); pass "
                               "--dataparser nerfstudio-data (or blender-data) to read the capture with a ported one")


@dataclasses.dataclass
class UnportedDataParserConfig(DataParserConfig):
    """The reference's parser ``name`` in a method config (phototourism's,
    semantic-nerfw's): setting it up raises, naming the ROADMAP item that
    ports it."""

    name: str = ""

    def setup(self):
        raise _not_ported(self.name)


def get_dataparser_config(name: str) -> DataParserConfig:
    """A fresh config of the parser ``name`` (or its short alias without
    ``-data``)."""
    for key in (name, f"{name}-data"):
        if key in DATAPARSERS:
            return DATAPARSERS[key]()
        if key in NOT_PORTED:
            raise _not_ported(key)
    raise KeyError(f"unknown dataparser {name!r}; ported: {sorted(DATAPARSERS)}")
