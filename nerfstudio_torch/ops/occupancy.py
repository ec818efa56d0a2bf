"""Occupancy grid (counterpart of ``nerfstudio_tpu/ops/occupancy.py``).

The grid is stored flat: ``binary`` and ``densities`` are ``(res^3,)`` with
cell (i, j, k) at ``(i*res + j)*res + k``. Probing is an index lookup, a
stock torch gather; the reference's row-packed probe views exist only for
the TPU's gather unit and are not kept. ``update_occupancy_grid`` is the
reference's plain ``jnp`` EMA refresh, in stock torch ops.
``OccupancyGridSampler`` is the reference's stand-in for nerfacc's
occupancy marching: probes along each ray weighted by the grid, then a
fixed budget of PDF samples."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from nerfstudio_torch.core.rays import RayBundle, RaySamples
from nerfstudio_torch.model_components.ray_samplers import PDFSampler, SpacedSampler, UniformSampler
from nerfstudio_torch.utils.device import resolve_device


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
    """A fully occupied grid with zero densities (reference :57-68), on
    ``device`` (None: the GPU)."""
    n = resolution**3
    device = resolve_device(device)
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


def probe_density(grid: OccupancyGridState, positions: torch.Tensor) -> torch.Tensor:
    """The EMA density of the nearest cell at each position (reference
    :148-154), rounded to bfloat16 as the reference's row gather rounds its
    table: nerfacto's net-free proposal signal."""
    cells = _cell_indices(positions, grid.aabb, grid.resolution)
    return grid.densities[cells].to(torch.bfloat16).to(torch.float32)


def update_occupancy_grid(
    grid: OccupancyGridState,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
    occ_thre: float = 0.01,
    ema_decay: float = 0.95,
    cells_per_update: Optional[int] = None,
    cells: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
) -> OccupancyGridState:
    """EMA refresh at jittered cell centres (reference :78-125): the sampled
    cells become ``max(old * decay, density)``, then
    ``binary = densities > min(mean(densities), occ_thre)``.

    ``cells_per_update`` cells are drawn uniformly with replacement (all
    cells when None), and a uniform jitter in [0, 1)^3 per cell, from
    ``generator``; ``cells`` (int, (k,)) and ``jitter`` ((k, 3)) hand them
    in instead. A cell drawn more than once keeps the largest of its
    refreshed values (the reference's ``.at[].set`` leaves the winner
    unspecified). Returns a new state; the old one is not modified."""
    res = grid.resolution
    n = res**3
    device = grid.densities.device
    if cells is None:
        if cells_per_update is not None and cells_per_update < n:
            cells = torch.randint(0, n, (cells_per_update,), generator=generator, device=device)
        else:
            cells = torch.arange(n, device=device)
    cells = cells.to(device=device, dtype=torch.int64)
    if jitter is None:
        jitter = torch.rand((cells.shape[0], 3), generator=generator, device=device)
    ijk = torch.stack([cells // (res * res), (cells // res) % res, cells % res], dim=-1).to(torch.float32)
    unit = (ijk + jitter) / res
    positions = grid.aabb[0] + unit * (grid.aabb[1] - grid.aabb[0])
    with torch.no_grad():
        new_d = density_fn(positions)[..., 0]
    refreshed = torch.maximum(grid.densities[cells] * ema_decay, new_d)
    densities = grid.densities.scatter_reduce(0, cells, refreshed, reduce="amax", include_self=False)
    thresh = torch.clamp_max(torch.mean(densities), occ_thre)
    return OccupancyGridState(densities, densities > thresh, grid.aabb, res)


@dataclasses.dataclass(frozen=True)
class OccupancyGridSampler:
    """Occupancy-driven importance sampling (reference :157-197): the
    ``initial_sampler``'s probes (by default ``num_coarse_probes`` uniform
    midpoints, no jitter), mapped into the grid's coordinates by
    ``coord_fn`` where one is given, weigh 1 where they lie strictly inside
    the grid's aabb in an occupied cell and ``empty_weight`` elsewhere;
    ``num_samples`` PDF samples follow those weights (no histogram padding,
    one jitter per ray)."""

    num_coarse_probes: int = 128
    num_samples: int = 48
    empty_weight: float = 1e-3
    coord_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    initial_sampler: Optional[SpacedSampler] = None

    def probe_weights(self, grid: OccupancyGridState, probes: RaySamples) -> torch.Tensor:
        """(R, M, 1) weights of the probes."""
        pos = probes.frustums.get_positions()
        if self.coord_fn is not None:
            pos = self.coord_fn(pos)
        occupied = probe_occupancy(grid, pos) > 0.5
        inside = torch.all((pos > grid.aabb[0]) & (pos < grid.aabb[1]), dim=-1)
        return torch.where(occupied & inside, 1.0, self.empty_weight)[..., None]

    def __call__(self, ray_bundle: RayBundle, grid: OccupancyGridState, generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None) -> RaySamples:
        """``uniforms``: the PDF's jitter (R, 1) in [0, 1), else drawn from
        ``generator``; with neither, the PDF's midpoints (eval)."""
        init = self.initial_sampler or UniformSampler(self.num_coarse_probes, train_stratified=False)
        coarse = init(ray_bundle)
        pdf = PDFSampler(num_samples=self.num_samples, histogram_padding=0.0, single_jitter=True)
        return pdf(ray_bundle, coarse, self.probe_weights(grid, coarse), generator=generator, uniforms=uniforms)
