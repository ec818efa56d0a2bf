"""Ray datastructures: Frustums, RaySamples, RayBundle.

Counterpart of ``nerfstudio_tpu/core/rays.py``: plain dataclasses of
tensors with fixed ``(num_rays, num_samples)`` shapes, and the
alpha-compositing weights as a pure function. A bundle's ``times`` (a
dynamic scene's camera times) reach its samples, whose frustums carry the
temporal distortion's ``offsets``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from nerfstudio_torch.utils.math import clip, conical_frustum_to_gaussian


@dataclasses.dataclass
class Frustums:
    """Cone frustums along rays (reference rays.py:20-54)."""

    origins: torch.Tensor  # (..., 3)
    directions: torch.Tensor  # (..., 3)
    starts: torch.Tensor  # (..., 1)
    ends: torch.Tensor  # (..., 1)
    pixel_area: torch.Tensor  # (..., 1)
    offsets: Optional[torch.Tensor] = None  # (..., 3), D-NeRF's temporal distortion

    def get_positions(self) -> torch.Tensor:
        """Midpoint positions, moved by ``offsets`` where set (reference :29-37)."""
        pos = self.origins + self.directions * (self.starts + self.ends) / 2
        if self.offsets is not None:
            pos = pos + self.offsets
        return pos

    def get_gaussian_blob(self):
        """mip-NeRF's Gaussian of each frustum (reference rays.py:43-55): a
        cone of radius sqrt(pixel_area) / sqrt(pi) per unit distance."""
        return conical_frustum_to_gaussian(self.origins, self.directions, self.starts, self.ends,
                                           torch.sqrt(self.pixel_area) / 1.7724538509055159)


@dataclasses.dataclass
class RaySamples:
    """Samples along rays (reference rays.py:57-108).

    ``spacing_starts/ends`` are in the warped [0,1] spacing domain of the
    spaced samplers; euclidean bin edges are ``frustums.starts/ends``."""

    frustums: Frustums
    camera_indices: Optional[torch.Tensor] = None  # (..., 1) int
    deltas: Optional[torch.Tensor] = None  # (..., 1)
    spacing_starts: Optional[torch.Tensor] = None  # (..., num_samples, 1)
    spacing_ends: Optional[torch.Tensor] = None
    metadata: Optional[Dict[str, torch.Tensor]] = None
    times: Optional[torch.Tensor] = None  # (..., 1)
    spacing_to_euclidean_fn: Optional[Callable] = None

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """Transmittance-weighted alpha compositing weights."""
        return render_weights_from_density(densities, self.deltas)

    @staticmethod
    def get_weights_and_transmittance_from_alphas(alphas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, transmittance) from per-sample alphas (..., S, 1)
        (reference rays.py:100): the exclusive product of (1 - alpha) taken
        as a cumulative sum of logs, 1 - alpha clipped to [1e-10, 1]."""
        log_1m = torch.log(clip(1.0 - alphas, 1e-10, 1.0))
        transmittance = torch.exp(torch.cumsum(log_1m, dim=-2) - log_1m)
        return alphas * transmittance, transmittance


def render_weights_from_density(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``alpha * T`` with ``alpha = 1 - exp(-sigma delta)`` and the exclusive
    transmittance ``T_i = exp(-sum_{j<i} sigma_j delta_j)`` (reference :111-117)."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    transmittance = torch.exp(-(torch.cumsum(delta_density, dim=-2) - delta_density))
    return alphas * transmittance


@dataclasses.dataclass
class RayBundle:
    """A bundle of rays (reference rays.py:120-181)."""

    origins: torch.Tensor  # (..., 3)
    directions: torch.Tensor  # (..., 3)
    pixel_area: torch.Tensor  # (..., 1)
    camera_indices: Optional[torch.Tensor] = None  # (..., 1) int
    nears: Optional[torch.Tensor] = None  # (..., 1)
    fars: Optional[torch.Tensor] = None  # (..., 1)
    metadata: Optional[Dict[str, torch.Tensor]] = None
    times: Optional[torch.Tensor] = None  # (..., 1)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.origins.shape[:-1])

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RayBundle":
        """Apply ``fn`` to every tensor field, metadata included; the batch
        dimensions lead every field, so reshapes, slices and pads over them
        go through here."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                v = {k: fn(x) for k, x in v.items()}
            elif v is not None:
                v = fn(v)
            kw[f.name] = v
        return RayBundle(**kw)

    def flatten(self) -> "RayBundle":
        nb = len(self.shape)
        return self.map(lambda x: x.reshape((-1,) + tuple(x.shape[nb:])))

    def get_ray_samples(
        self,
        bin_starts: torch.Tensor,
        bin_ends: torch.Tensor,
        spacing_starts: Optional[torch.Tensor] = None,
        spacing_ends: Optional[torch.Tensor] = None,
        spacing_to_euclidean_fn: Optional[Callable] = None,
    ) -> RaySamples:
        """RaySamples from bin edges (reference :146-181)."""
        deltas = bin_ends - bin_starts
        lead = tuple(bin_starts.shape[:-1])

        def broadcast(x):
            if x is None:
                return None
            return x[..., None, :].expand(lead + x.shape[-1:])

        frustums = Frustums(
            origins=broadcast(self.origins),
            directions=broadcast(self.directions),
            starts=bin_starts,
            ends=bin_ends,
            pixel_area=broadcast(self.pixel_area),
        )
        return RaySamples(
            frustums=frustums,
            camera_indices=broadcast(self.camera_indices),
            deltas=deltas,
            spacing_starts=spacing_starts,
            spacing_ends=spacing_ends,
            metadata=(
                {k: broadcast(v) for k, v in self.metadata.items()}
                if self.metadata is not None
                else None
            ),
            times=broadcast(self.times),
            spacing_to_euclidean_fn=spacing_to_euclidean_fn,
        )
