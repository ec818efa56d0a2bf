"""Poisson surface reconstruction on a regular grid via FFT (counterpart of
``nerfstudio_tpu/exporter/poisson.py``, an independent grid formulation of
screened Poisson's equation):

  1. splat the oriented points' normals into a vector field V on the grid
     (trilinear, ``index_put_`` with accumulation),
  2. solve  Δχ = ∇·V  with the Gaussian smoothing folded into the FFT
     diagonalisation (``torch.fft.fftn``/``ifftn`` in complex64),
  3. take the iso level as the mean of χ at the samples,
  4. marching cubes on χ - iso (host numpy).

Plain PyTorch ops on the device. The scatter adds in float32 in no fixed
order on the card, so card and CPU agree to a tolerance."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.exporter.marching_cubes import marching_cubes
from nerfstudio_torch.utils.device import resolve_device


def poisson_reconstruct(
    points: np.ndarray,  # (N, 3)
    normals: np.ndarray,  # (N, 3) oriented (outward)
    aabb: Optional[Tuple] = None,
    resolution: int = 128,
    smooth_sigma: float = 1.5,
    device=None,
) -> Tuple[np.ndarray, float, Tuple[np.ndarray, np.ndarray]]:
    """(chi (R, R, R) float32, iso level, the aabb used) on ``device``
    (None: the GPU); without ``aabb`` the points' box padded by a tenth of
    its largest side (reference :24-80)."""
    device = resolve_device(device)
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    if aabb is None:
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        pad = 0.1 * (hi - lo).max()
        aabb = (lo - pad, hi + pad)
    aabb = (np.asarray(aabb[0], np.float32), np.asarray(aabb[1], np.float32))
    res = resolution

    # 1. the normals splatted into the grid (trilinear scatter)
    u_np = np.clip((points - aabb[0]) / (aabb[1] - aabb[0]) * (res - 1), 0, res - 1 - 1e-4)
    u = torch.from_numpy(u_np).to(device)
    nrm = torch.from_numpy(normals).to(device)
    base = torch.floor(u).to(torch.int32)
    frac = u - base
    V = torch.zeros((res, res, res, 3), dtype=torch.float32, device=device)
    for corner in range(8):
        d = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1], dtype=torch.int32, device=device)
        idx = (base + d).long()
        wgt = torch.prod(torch.where(d == 1, frac, 1 - frac), dim=-1)
        V.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), nrm * wgt[:, None], accumulate=True)

    # 2. Gaussian smoothing and the solve in the Fourier domain: div V as
    # i k . V_hat, then chi_hat = div_hat / (-|k|^2), 0 at k = 0
    k = torch.fft.fftfreq(res, device=device) * (2 * np.float32(np.pi))  # grid units
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    k2 = kx**2 + ky**2 + kz**2
    gauss = torch.exp(-0.5 * smooth_sigma**2 * k2)
    Vx_h = torch.fft.fftn(V[..., 0].to(torch.complex64)) * gauss
    Vy_h = torch.fft.fftn(V[..., 1].to(torch.complex64)) * gauss
    Vz_h = torch.fft.fftn(V[..., 2].to(torch.complex64)) * gauss
    div_h = 1j * (kx * Vx_h + ky * Vy_h + kz * Vz_h)
    live = k2 > 1e-12
    denom = torch.where(live, -k2, 1.0)
    chi_h = torch.where(live, div_h / denom, 0.0)
    chi = torch.fft.ifftn(chi_h).real

    # 3. the iso level: the mean of chi at the samples' nearest voxels
    ui = torch.clamp(torch.round(u).to(torch.int32), 0, res - 1).long()
    iso = float(torch.mean(chi[ui[:, 0], ui[:, 1], ui[:, 2]]))
    return chi.cpu().numpy(), iso, aabb


def export_poisson_mesh(
    points: np.ndarray,
    normals: np.ndarray,
    resolution: int = 128,
    aabb=None,
    device=None,
):
    """Points and normals -> (verts, faces) (reference :83-87)."""
    chi, iso, box = poisson_reconstruct(points, normals, aabb, resolution, device=device)
    return marching_cubes(chi - iso, level=0.0, aabb=(tuple(box[0]), tuple(box[1])))
