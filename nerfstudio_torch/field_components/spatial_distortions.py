"""Spatial distortions (counterpart of
``nerfstudio_tpu/field_components/spatial_distortions.py``).

``SceneContraction``: the mip-NeRF 360 contraction
x -> (2 - 1/||x||) * x/||x|| for ||x|| > 1, on points only. The Gaussian
(covariance) overload is not ported."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


class SceneContraction:
    """(reference spatial_distortions.py:27-57)"""

    def __init__(self, order: Optional[Union[float, int, str]] = None):
        if order == "inf":
            order = math.inf
        self.order = order

    def _contract(self, x: torch.Tensor) -> torch.Tensor:
        if self.order == math.inf:
            mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        else:
            mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        mag = torch.clamp_min(mag, 1e-10)
        contracted = (2.0 - 1.0 / mag) * (x / mag)
        return torch.where(mag < 1.0, x, contracted)

    def __call__(self, positions: torch.Tensor) -> torch.Tensor:
        if not isinstance(positions, torch.Tensor):
            raise NotImplementedError("only point positions are contracted; Gaussians are not ported")
        return self._contract(positions)
