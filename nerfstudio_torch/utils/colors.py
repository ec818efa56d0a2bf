"""Named colours (counterpart of ``nerfstudio_tpu/utils/colors.py``), as
float32 (3,) tensors on the CPU."""

from __future__ import annotations

import torch

COLORS_DICT = {
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
}


def get_color(color) -> torch.Tensor:
    """Name or [r, g, b] -> (3,) float32 (reference colors.py:16-27)."""
    if isinstance(color, str):
        color = color.lower()
        if color not in COLORS_DICT:
            raise ValueError(f"{color} is not a valid preset color")
        return torch.tensor(COLORS_DICT[color], dtype=torch.float32)
    if isinstance(color, (list, tuple)):
        if len(color) != 3:
            raise ValueError(f"Color should be 3 values (RGB) instead got {color}")
        return torch.tensor(color, dtype=torch.float32)
    raise ValueError(f"Color should be an RGB list or string, instead got {type(color)}")
