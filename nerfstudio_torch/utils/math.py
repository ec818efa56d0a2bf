"""Math helpers (counterpart of the matching functions of
``nerfstudio_tpu/utils/math.py``): splatfacto's init, and ``clip`` with
``jnp.clip``'s gradient."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: a max/min pair, whose derivative is 1/2
    where ``x`` sits exactly on a bound (``torch.clamp`` passes 1 there). The
    bounds are filled on ``x``'s device (``new_tensor`` would copy them
    from the host and wait for the card)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def random_quat(n: int, generator: Optional[torch.Generator] = None, uniforms: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """Uniform random unit quaternions wxyz (reference :224-235). ``uniforms``
    (3, n) in [0, 1) hands the draws in; otherwise they come from
    ``generator``."""
    if uniforms is None:
        uniforms = torch.rand((3, n), generator=generator, device=device)
    u, v, w = uniforms
    return torch.stack(
        [
            torch.sqrt(1 - u) * torch.sin(2 * math.pi * v),
            torch.sqrt(1 - u) * torch.cos(2 * math.pi * v),
            torch.sqrt(u) * torch.sin(2 * math.pi * w),
            torch.sqrt(u) * torch.cos(2 * math.pi * w),
        ],
        dim=-1,
    )


def k_nearest_neighbors(points: torch.Tensor, k: int, block: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN distances (excluding the point itself) from a row-blocked
    distance matrix (reference :238-279): (distances (n, k), indices (n, k)).

    Candidates come from ``|r|^2 + |p|^2 - 2 r.p``; the winners' distances are
    then recomputed from the coordinates, because the identity loses ~1e-3
    absolute to float32 cancellation, which wrecks the log-scale init of
    near-duplicate points."""
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    dists, idxs = [], []
    for start in range(0, n, block):
        rows = points[start:start + block]
        d2 = torch.sum(rows * rows, dim=-1)[:, None] + sq[None, :] - 2.0 * (rows @ points.T)
        own = torch.arange(start, start + rows.shape[0], device=points.device)
        d2[torch.arange(rows.shape[0], device=points.device), own] = math.inf
        idx = torch.topk(d2, k, dim=-1, largest=False).indices
        exact = torch.sum((rows[:, None, :] - points[idx]) ** 2, dim=-1)
        dists.append(torch.sqrt(torch.clamp_min(exact, 0.0)))
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)
