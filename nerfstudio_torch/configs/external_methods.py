"""Catalog of third-party methods installable as plugins (counterpart of
``nerfstudio_tpu/configs/external_methods.py``; reference
nerfstudio/configs/external_methods.py:30-361).

These are not bundled: asking for one prints its install instructions.
Installed, they appear through the ``nerfstudio_torch.method_configs``
entry-point group (``plugins.py``), as in the reference."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class ExternalMethod:
    """A known third-party method (reference external_methods.py:34-45)."""

    instructions: str
    configurations: List[Tuple[str, str]]  # (method name, description)
    pip_package: str = ""


external_methods = [
    ExternalMethod(
        instructions="Instruct-NeRF2NeRF: text-driven NeRF scene editing.\n"
        "  pip install git+https://github.com/ayaanzhaque/instruct-nerf2nerf",
        configurations=[
            ("in2n", "Instruct-NeRF2NeRF (full model, ~15GB)"),
            ("in2n-small", "Instruct-NeRF2NeRF (half precision)"),
            ("in2n-tiny", "Instruct-NeRF2NeRF (no LPIPS, ~8GB)"),
        ],
        pip_package="git+https://github.com/ayaanzhaque/instruct-nerf2nerf",
    ),
    ExternalMethod(
        instructions="K-Planes: explicit space(-time) planes.\n"
        "  pip install kplanes-nerfstudio",
        configurations=[
            ("kplanes", "K-Planes (static scenes)"),
            ("kplanes-dynamic", "K-Planes (dynamic scenes)"),
        ],
        pip_package="kplanes-nerfstudio",
    ),
    ExternalMethod(
        instructions="LERF: language-embedded radiance fields.\n  pip install lerf",
        configurations=[
            ("lerf-big", "LERF with OpenCLIP ViT-L/14"),
            ("lerf", "LERF with OpenCLIP ViT-B/16"),
            ("lerf-lite", "LERF with smaller memory footprint"),
        ],
        pip_package="lerf",
    ),
    ExternalMethod(
        instructions="Tetra-NeRF: tetrahedra-based representation.\n"
        "  see https://github.com/jkulhanek/tetra-nerf",
        configurations=[
            ("tetra-nerf-original", "Tetra-NeRF (original)"),
            ("tetra-nerf", "Tetra-NeRF (latest)"),
        ],
    ),
    ExternalMethod(
        instructions="NeRFPlayer: dynamic scene playback.\n"
        "  pip install git+https://github.com/lsongx/nerfplayer-nerfstudio",
        configurations=[
            ("nerfplayer-nerfacto", "NeRFPlayer with nerfacto backbone"),
            ("nerfplayer-ngp", "NeRFPlayer with instant-ngp backbone"),
        ],
    ),
    ExternalMethod(
        instructions="Volinga: mobile/web real-time viewing.\n"
        "  pip install git+https://github.com/Volinga/volinga-model",
        configurations=[("volinga", "Real-time rendering (Volinga)")],
    ),
    ExternalMethod(
        instructions="BioNeRF: biologically plausible radiance fields.\n"
        "  pip install git+https://github.com/Leandropassosjr/ns_bionerf",
        configurations=[("bionerf", "BioNeRF")],
    ),
    ExternalMethod(
        instructions="Instruct-GS2GS: text-driven 3DGS editing.\n"
        "  pip install git+https://github.com/cvachha/instruct-gs2gs",
        configurations=[("igs2gs", "Instruct-GS2GS")],
    ),
    ExternalMethod(
        instructions="PyNeRF: pyramidal multi-scale NeRF.\n"
        "  pip install git+https://github.com/hturki/pynerf",
        configurations=[
            ("pynerf", "PyNeRF"),
            ("pynerf-synthetic", "PyNeRF (synthetic scenes)"),
            ("pynerf-occupancy-grid", "PyNeRF (occupancy grid)"),
        ],
    ),
    ExternalMethod(
        instructions="SeaThru-NeRF: underwater scene reconstruction.\n"
        "  pip install git+https://github.com/AkerBP/seathru_nerf",
        configurations=[("seathru-nerf", "SeaThru-NeRF"), ("seathru-nerf-lite", "SeaThru-NeRF lite")],
    ),
    ExternalMethod(
        instructions="Zip-NeRF: anti-aliased grid-based NeRF.\n"
        "  pip install git+https://github.com/SuLvXiangXin/zipnerf-pytorch#subdirectory=extensions/cuda\n"
        "  pip install git+https://github.com/SuLvXiangXin/zipnerf-pytorch",
        configurations=[("zipnerf", "Zip-NeRF")],
    ),
]


def get_external_methods():
    """-> (descriptions {name: text}, instructions {name: install text})."""
    descriptions, instructions = {}, {}
    for m in external_methods:
        for name, desc in m.configurations:
            descriptions[name] = f"[external] {desc}"
            instructions[name] = m.instructions
    return descriptions, instructions
