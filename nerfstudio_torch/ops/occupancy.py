"""Occupancy grid (counterpart of ``nerfstudio_tpu/ops/occupancy.py``).

The grid is stored flat: ``binary`` and ``densities`` are ``(res^3,)`` with
cell (i, j, k) at ``(i*res + j)*res + k``. Probing is an index lookup, a
stock torch gather; the reference's row-packed probe views exist only for
the TPU's gather unit and are not kept. ``update_occupancy_grid`` is
training work and is not ported."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class OccupancyGridState:
    densities: torch.Tensor  # (res^3,) EMA of raw density at cell centres
    binary: torch.Tensor  # (res^3,) bool
    aabb: torch.Tensor  # (2, 3)
    resolution: int = 128

    def to(self, device) -> "OccupancyGridState":
        return OccupancyGridState(
            self.densities.to(device), self.binary.to(device), self.aabb.to(device), self.resolution
        )


def init_occupancy_grid(aabb, resolution: int = 128, device=None) -> OccupancyGridState:
    """A fully occupied grid with zero densities (reference :57-68)."""
    n = resolution**3
    return OccupancyGridState(
        densities=torch.zeros((n,), dtype=torch.float32, device=device),
        binary=torch.ones((n,), dtype=torch.bool, device=device),
        aabb=torch.as_tensor(aabb, dtype=torch.float32, device=device),
        resolution=resolution,
    )


def _cell_indices(positions: torch.Tensor, aabb: torch.Tensor, res: int) -> torch.Tensor:
    """World positions -> flat cell index; out-of-aabb clamps to the border
    (reference :71-75)."""
    unit = (positions - aabb[0]) / (aabb[1] - aabb[0])
    ijk = torch.clamp((unit * res).to(torch.int64), 0, res - 1)
    return (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]


def probe_occupancy(grid: OccupancyGridState, positions: torch.Tensor) -> torch.Tensor:
    """Occupancy (1.0/0.0) of the nearest cell at each position (reference :140-145)."""
    return grid.binary[_cell_indices(positions, grid.aabb, grid.resolution)].to(torch.float32)
