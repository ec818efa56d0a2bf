"""Marching cubes over a density or SDF field (counterpart of
``nerfstudio_tpu/exporter/marching_cubes.py``).

``evaluate_grid`` runs the field on a dense grid in chunks under no_grad on
the field's device (nerfacto's field in eval mode: K3 for each chunk); the
grid's positions are the reference's float64 linspaces rounded to float32,
made a chunk at a time. The last chunk is not padded: nothing recompiles.
Marching cubes itself stays host numpy, as in the reference, with the
Lorensen-Cline tables of ``mc_tables``."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.exporter.mc_tables import CORNER_OFFSETS, EDGE_CORNERS, TRI_TABLE
from nerfstudio_torch.utils.device import resolve_device


def evaluate_grid(
    field_fn: Callable[[torch.Tensor], torch.Tensor],
    resolution: int = 256,
    aabb=((-1, -1, -1), (1, 1, 1)),
    chunk: int = 262144,
    device=None,
) -> np.ndarray:
    """The scalar field at every point of a resolution^3 grid spanning
    ``aabb`` (ends included) -> (res, res, res) float32 numpy; ``field_fn``
    takes (N, 3) float32 positions on ``device`` (None: the GPU) and returns
    (N, 1) (reference :17-36)."""
    device = resolve_device(device)
    aabb = np.asarray(aabb, np.float32)
    lin = [np.linspace(aabb[0][d], aabb[1][d], resolution) for d in range(3)]
    n = resolution**3
    out = np.zeros(n, np.float32)
    with torch.no_grad():
        for i in range(0, n, chunk):
            ix, iy, iz = np.unravel_index(np.arange(i, min(n, i + chunk)), (resolution,) * 3)
            piece = np.stack([lin[0][ix], lin[1][iy], lin[2][iz]], axis=-1).astype(np.float32)
            out[i : i + len(piece)] = field_fn(torch.from_numpy(piece).to(device))[..., 0].float().cpu().numpy()
    return out.reshape(resolution, resolution, resolution)


def _marching_cubes_native(volume: np.ndarray, level: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized numpy marching cubes (reference :39-105): (verts (V, 3)
    in index coords, faces (F, 3)). Vertices on shared cube edges are
    deduplicated through a global edge id."""
    nx, ny, nz = volume.shape
    # cube corner values: (nx-1, ny-1, nz-1, 8)
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    corner_vals = np.empty((cx, cy, cz, 8), volume.dtype)
    for i, (dx, dy, dz) in enumerate(CORNER_OFFSETS):
        corner_vals[..., i] = volume[dx : dx + cx, dy : dy + cy, dz : dz + cz]
    cube_index = np.zeros((cx, cy, cz), np.int32)
    for i in range(8):
        cube_index |= (corner_vals[..., i] < level).astype(np.int32) << i

    active = np.nonzero((cube_index != 0) & (cube_index != 255))
    if len(active[0]) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    ci = cube_index[active]  # (M,)
    tris = TRI_TABLE[ci]  # (M, 16)
    base = np.stack(active, axis=-1).astype(np.int64)  # (M, 3) cube coords

    # every triangle's three edge slots
    n_tri_slots = 5
    tri_edges = tris[:, : n_tri_slots * 3].reshape(-1, 3)  # (M*5, 3)
    valid_tri = tri_edges[:, 0] >= 0
    tri_edges = tri_edges[valid_tri]
    cube_of_tri = np.repeat(np.arange(len(base)), n_tri_slots)[valid_tri]

    # global edge id: (cube, local edge) -> canonical (voxel, axis); local
    # edge k joins corners a and b: anchor = the lesser corner offset, axis =
    # the coordinate that differs
    ec = EDGE_CORNERS
    a_off = CORNER_OFFSETS[ec[:, 0]]
    b_off = CORNER_OFFSETS[ec[:, 1]]
    anchor = np.minimum(a_off, b_off)  # (12, 3)
    axis = np.argmax(np.abs(a_off - b_off), axis=1)  # (12,)

    def edge_key(cubes, edges):
        pos = base[cubes] + anchor[edges]  # (K, 3)
        ax = axis[edges]
        return ((pos[:, 0] * ny + pos[:, 1]) * nz + pos[:, 2]) * 3 + ax

    flat_edges = tri_edges.reshape(-1)  # (K*3,)
    flat_cubes = np.repeat(cube_of_tri, 3)
    keys = edge_key(flat_cubes, flat_edges)
    uniq, inverse = np.unique(keys, return_inverse=True)
    faces = inverse.reshape(-1, 3)

    # vertex positions: interpolated along each unique edge
    vox = uniq // 3
    ax = (uniq % 3).astype(np.int64)
    p0 = np.stack([vox // (ny * nz), (vox // nz) % ny, vox % nz], axis=-1).astype(np.float64)
    p1 = p0.copy()
    p1[np.arange(len(ax)), ax] += 1
    i0 = p0.astype(np.int64)
    i1 = p1.astype(np.int64)
    v0 = volume[i0[:, 0], i0[:, 1], i0[:, 2]].astype(np.float64)
    v1 = volume[i1[:, 0], i1[:, 1], i1[:, 2]].astype(np.float64)
    denom = np.where(np.abs(v1 - v0) > 1e-12, v1 - v0, 1.0)
    t = np.clip((level - v0) / denom, 0.0, 1.0)
    verts = p0 + (p1 - p0) * t[:, None]
    # drop degenerate faces (two slots on one edge after clamping)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[good]


def marching_cubes(
    volume: np.ndarray, level: float = 0.0, aabb=((-1, -1, -1), (1, 1, 1))
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The ``level`` surface of a (R, R, R) volume spanning ``aabb`` ->
    (vertices (V, 3) in world coords, faces (F, 3)) (reference :108-116)."""
    aabb = np.asarray(aabb, np.float32)
    res = volume.shape[0]
    scale = (aabb[1] - aabb[0]) / (res - 1)
    verts, faces = _marching_cubes_native(volume, level)
    return verts * scale + aabb[0], faces


def generate_mesh_with_multires_marching_cubes(
    sdf_fn, resolution: int = 512, aabb=((-1, -1, -1), (1, 1, 1)), coarse_factor: int = 4, device=None
):
    """The SDF's zero surface on one full fine grid, as the reference's
    simplified multi-resolution scheme does (reference :119-127;
    ``coarse_factor`` is accepted and unused, as there)."""
    vol = evaluate_grid(sdf_fn, resolution=resolution, aabb=aabb, device=device)
    return marching_cubes(vol, level=0.0, aabb=aabb)
