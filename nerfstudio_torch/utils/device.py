"""Where the port's entry points put their tensors.

Every constructor and state initialiser that takes ``device=None``
resolves it here: the port runs on the GPU unless the caller names
another device (the CPU tests pass ``device="cpu"``). Without CUDA a
missing device is an error, never a silent fall back to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``. A CUDA device
    must be available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerfstudio_torch runs on a CUDA device by default and none is available: "
            'pass device="cpu" to run on the CPU'
        )
    return device
