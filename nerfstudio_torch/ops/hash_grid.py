"""Multiresolution hash-grid encoding (Instant-NGP).

Counterpart of ``nerfstudio_tpu/ops/hash_grid.py``. Tables keep the JAX
package's ``(L, S, 128)`` float32 layout, so JAX tables load without
repacking. Three paths are ported:

* ``hash_encode(block=True)`` (K1): one 2x2x2 vertex block per
  (sample, level), odd axes rounded stochastically from a hash of the cell
  offset's float bits. Differentiable twice: a ``torch.autograd.Function``
  whose backward (K1 bwd, with the reference's one-hot K2 folded in) is
  itself a Function (``_BlockEncodeBwd``): it scatters the table gradient
  and carries the corner-weight gradient to the positions, and its own
  backward (K1bb) takes the cotangent of the position gradient back to the
  encoding's cotangent, the table and the positions, as the reference's
  autodiff of its backward does (the density-gradient normals' loss).
  ``bwd_levels``/``bwd_scale`` give the level-subsampled backward, which
  scales the second-order table gradient alike. A cotangent of the table
  gradient itself raises: no path asks for one;
* ``hash_encode(block_exact=True)`` (K3): the exact 8-corner trilerp through
  the same layout, differentiable in the positions (K3b, the eval normals'
  position gradient); a table gradient through it raises;
* ``hash_encode()`` with neither flag (K7): the exact 8-corner trilerp over
  the flat layout, entry e of a level at lanes e*F..e*F+F-1 of the
  row-major (S, 128) table, dense or hashed per level, so JAX's tables
  load without repacking. Differentiable once: its backward scatters the
  table gradient in float32 and carries the corner-weight gradient to the
  positions.

Each dispatches on the device of its inputs: CUDA tensors go to the
hand-written kernels in ``csrc/hash_grid.cu`` (or the call raises), CPU
tensors go to the plain PyTorch twins in this module. The one-corner and
z-pair paths are not ported. A backward asks only for the gradients that
the running backward pass reads (``_engine_needs``): the normals' position
gradient scatters no table gradient, as the reference's dead-code
elimination drops it.

Every kernel (the forward and backward of K1 and K7, K3, K3b and K1bb)
has two designs on the card (``DESIGNS``): a group of lanes per (sample,
level) with 8- or 16-byte loads and, in the backwards, one vector
reduction per corner, which F = 2 and 4 take; and the first design, one
thread per (sample, level) or, in the first-order backward, per sample
with scalar atomics, which the other widths take.
K7's backward in lane groups, asked for the table gradient alone, first
reduces the dense coarse levels in shared memory (``bwd_plan``).
``chip_smoke.py`` times every design.

Integer hashing runs on int64 with the uint32 wrap made explicit
(``_mul32``), so the twin reproduces the reference's uint32 arithmetic
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.math import clip

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# odd-axis coin multipliers per axis (reference block_level_geometry)
_COIN_PRIMES = (
    (0x85EBCA6B, 0x9E3779B1),
    (0xC2B2AE35, 0x27D4EB2F),
    (0x165667B1, 0xD3A2646C),
)

# Launches of each hand-written kernel, counted where the kernel is launched.
launch_counts: Dict[str, int] = {
    "hash_encode_block": 0,
    "hash_encode_block_exact": 0,
    "hash_encode_block_bwd": 0,
    "hash_encode_flat": 0,
    "hash_encode_flat_bwd": 0,
    # K3b: K3's position gradient (the eval normals)
    "hash_encode_block_exact_bwd": 0,
    # K1bb: K1's backward differentiated again (the normals' loss in training)
    "hash_encode_block_bwd_bwd": 0,
    # K1 or K3 launches (counted above too) that took the per-thread design
    "hash_encode_block_per_thread": 0,
    # K1 bwd or K7 bwd launches (counted above too) that took the per-thread design
    "hash_encode_bwd_per_thread": 0,
    # K7 forward launches (counted above too) that took the per-thread design
    "hash_encode_flat_per_thread": 0,
    # K3b or K1bb launches (counted above too) that took the per-thread design
    "hash_encode_normals_per_thread": 0,
}

# Designs of every hash-grid kernel (K1 and K7 forward and backward, K3,
# K3b, K1bb), by their C design codes. "per-thread": one thread per (sample, level)
# (the forward) or per sample (the backward, with scalar atomics);
# "lane-groups": a stencil's corners loaded by a group of lanes as 8- or
# 16-byte vectors (K7's forward: a lane pair per stencil, one level per
# warp, a load instruction a z-pair of corners of 16 neighbouring
# samples), and in the backward one vector reduction per corner. K7's backward in lane
# groups also reduces the dense coarse levels in shared memory first when
# it is asked for the table gradient alone (``bwd_plan``).
DESIGNS = {"per-thread": 0, "lane-groups": 1}
# The widths the lane groups take, where every kernel takes them by default:
# the faster design at a render chunk's inputs (forward) and at the
# training steps' own inputs (backward) on the H100 (chip_smoke.py phases
# 20, 30, 31 and 67 time both designs in turns; PERF.md records the times).
# Other widths take the per-thread kernels.
_LANE_WIDTHS = (2, 4)
_DEFAULT = "lane-groups"
# Shared memory one block may take on the H100 (227 KB, opt-in above 48 KB).
# The CUDA entry re-checks a plan against its own copy (kMaxSharedBytes).
SHARED_BYTES_PER_BLOCK = 232_448


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _mul32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant ``p`` <
    2^32, without int64 overflow: p is split into 16-bit halves."""
    lo, hi = p & 0xFFFF, p >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _u01_hash(o: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """Uniform variate in [0, 1) from a float32's bits (reference :45-50)."""
    b = o.detach().contiguous().view(torch.int32).to(torch.int64) & _MASK32
    h = _mul32(b, p1) ^ _mul32(b >> 7, p2)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def compute_level_resolutions(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Geometric growth factor exp((ln max - ln min)/(L-1)) (reference :53-59)."""
    if num_levels > 1:
        growth = np.exp((np.log(max_res) - np.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    return np.floor(min_res * growth ** np.arange(num_levels)).astype(np.int64)


def _hash_corner(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, hash_table_size: int):
    """Spatial hash of non-negative integer coords (reference :732-736)."""
    h = (
        _mul32(cx.to(torch.int64) & _MASK32, _PRIMES[0])
        ^ _mul32(cy.to(torch.int64) & _MASK32, _PRIMES[1])
        ^ _mul32(cz.to(torch.int64) & _MASK32, _PRIMES[2])
    )
    return h % hash_table_size


def _block_level_layout(res: int, hash_table_size: int) -> Tuple[int, bool]:
    """(dense blocks per axis, whether the level is indexed densely)."""
    bs = (res + 2) // 2
    return bs, bs**3 * 8 <= hash_table_size


def _block_index(bx, by, bz, bs: int, dense_b: bool, nblocks: int) -> torch.Tensor:
    if dense_b:
        return (bx.to(torch.int64) * bs + by) * bs + bz
    return _hash_corner(bx, by, bz, nblocks)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1] with the reference's gradient (``utils.math.clip``)."""
    return clip(x, 0.0, 1.0)


def _base_cells(positions: torch.Tensor, res: int):
    """Per axis: base cell clipped to [0, res-1] and its offset in [0, 1],
    differentiable in the positions."""
    cells = []
    for a in range(3):
        s = positions[:, a] * res
        i0 = torch.clamp(torch.floor(s.detach()).to(torch.int64), 0, res - 1)
        cells.append((i0, _clip01(s - i0.to(torch.float32))))
    return cells


def _level_blocks(positions: torch.Tensor, res: int, hash_table_size: int, bpr: int, dtype=torch.float32):
    """One level of the stochastic block layout: ``(rows, slot, w8)``. The
    corner weights ``w8`` (n, 8) are built in ``dtype`` from the float32 cell
    offsets and carry autograd to the positions through the even axes."""
    bs, dense_b = _block_level_layout(res, hash_table_size)
    bcoords, pweights = [], []
    for (i0, o), (p1, p2) in zip(_base_cells(positions, res), _COIN_PRIMES):
        odd = (i0 & 1) == 1
        up = _u01_hash(o, p1, p2) < o
        # block of the chosen vertex on odd axes, of the base on even ones
        bcoords.append((i0 + (odd & up).to(torch.int64)) >> 1)
        upf = up.to(dtype)
        od = o.to(dtype)
        pweights.append((torch.where(odd, upf, 1.0 - od), torch.where(odd, 1.0 - upf, od)))
    blk = _block_index(*bcoords, bs, dense_b, hash_table_size // 8)
    (wx0, wx1), (wy0, wy1), (wz0, wz1) = pweights
    w8 = torch.stack(
        [
            (wx1 if (c >> 2) & 1 else wx0) * (wy1 if (c >> 1) & 1 else wy0) * (wz1 if c & 1 else wz0)
            for c in range(8)
        ],
        dim=-1,
    )
    return blk // bpr, blk % bpr, w8


def block_level_geometry(
    positions: torch.Tensor,
    *,
    num_levels: int,
    min_res: int,
    max_res: int,
    hash_table_size: int,
    features_per_level: int,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per level ``(rows (n,), slot (n,), w8 (n, 8))`` of the stochastic block
    layout (reference :611-682). positions: (n, 3) in [0, 1]."""
    epr = 128 // features_per_level
    assert hash_table_size % 8 == 0 and epr % 8 == 0
    return [
        _level_blocks(positions, int(res), hash_table_size, epr // 8)
        for res in compute_level_resolutions(num_levels, min_res, max_res)
    ]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back: the table read precision."""
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16_through(x: torch.Tensor) -> torch.Tensor:
    """``_bf16(x)`` whose gradient passes unrounded (``_bf16``'s would round
    it to bfloat16): ``x + (bf16(x) - x)`` is bf16(x) exactly, the
    difference being x's low mantissa bits."""
    return x + (_bf16(x.detach()) - x.detach())


def _block_lanes(rows: torch.Tensor, slot: torch.Tensor, f: int) -> torch.Tensor:
    """(n, 8F) flat lane indices of each sample's block within one level."""
    lane0 = rows * 128 + slot * (8 * f)
    return lane0[:, None] + torch.arange(8 * f, device=rows.device)


def _block_stochastic_twin(
    pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int, hash_table_size: int
) -> torch.Tensor:
    """Plain PyTorch K1 forward: (n, 3) -> (n, L*F)."""
    L = table.shape[0]
    F = 128 * table.shape[1] // hash_table_size
    n = pos.shape[0]
    geom = block_level_geometry(
        pos, num_levels=L, min_res=min_res, max_res=max_res,
        hash_table_size=hash_table_size, features_per_level=F,
    )
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    for l, (rows, slot, w8) in enumerate(geom):
        vals = _bf16(table[l].reshape(-1)[_block_lanes(rows, slot, F)]).view(n, 8, F)
        out[:, l * F : (l + 1) * F] = (w8[:, :, None] * vals).sum(dim=1)
    return out


def _block_stochastic_twin_bwd(
    pos: torch.Tensor,
    table: torch.Tensor,
    grad: torch.Tensor,
    scales: Sequence[float],
    *,
    min_res: int,
    max_res: int,
    hash_table_size: int,
    need_positions: bool = True,
    dtype: torch.dtype = torch.float32,
    create_graph: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch K1 backward (reference ``_row_gather_block_tw_bwd`` and
    ``_row_gather_block_tw_oh_bwd`` behind ``_grad_scale``/``stop_gradient``).

    grad: (n, L*F) cotangent of the encoding. Returns ``d_table`` (L, S, 128)
    and ``d_positions`` (n, 3) (None unless ``need_positions``), summed in
    ``dtype``: row ``rows``, lane ``slot*8F + c*F + f`` of level l gets
    ``scales[l] * w8[c] * g[l*F+f]`` (a level of scale 0 gets nothing), and
    ``d_w8[c] = sum_f g[l*F+f] * bf16(table value)`` on every level goes to
    the positions by autograd through ``_level_blocks``, whose clip carries
    the reference's 1/2 at exact cell corners. The geometry stays float32
    whatever ``dtype`` is, so a float64 run takes the same blocks.

    ``create_graph``: both results carry a graph to ``pos``, ``table`` and
    ``grad`` (whichever require one), so autograd differentiates the
    backward again as the reference's autodiff does: the twin of K1bb
    (``_block_stochastic_twin_bwd_bwd``), which the tests hold it to."""
    L, S, lanes = table.shape
    F = 128 * S // hash_table_size
    n = pos.shape[0]
    d_table = torch.zeros((L, S * lanes), dtype=dtype, device=pos.device)
    d_pos = torch.zeros((n, 3), dtype=dtype, device=pos.device) if need_positions else None
    if not create_graph:
        table, grad = table.detach(), grad.detach()
    for l, res in enumerate(compute_level_resolutions(L, min_res, max_res)):
        if not (scales[l] or need_positions):
            continue
        with torch.enable_grad():
            p = pos if create_graph else pos.detach().requires_grad_(need_positions)
            rows, slot, w8 = _level_blocks(p, int(res), hash_table_size, 16 // F, dtype)
        lanes_idx = _block_lanes(rows, slot, F)
        g = grad[:, l * F : (l + 1) * F].to(dtype)
        if scales[l]:
            contrib = scales[l] * (w8 if create_graph else w8.detach())[:, :, None] * g[:, None, :]
            d_table[l].index_add_(0, lanes_idx.reshape(-1), contrib.reshape(-1))
        if need_positions:
            if create_graph:  # the reference's table gradient scale, and an unrounded gradient
                vals = _bf16_through(_grad_scale(table[l], scales[l]).reshape(-1)[lanes_idx])
            else:
                vals = _bf16(table[l].reshape(-1)[lanes_idx])
            vals = vals.to(dtype).view(n, 8, F)
            d_w8 = (g[:, None, :] * vals).sum(dim=-1)
            d_pos = d_pos + torch.autograd.grad(w8, p, d_w8, create_graph=create_graph)[0].to(dtype)
    return d_table.view(L, S, lanes), d_pos


def _grad_scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x``, whose gradient autograd scales by ``c`` (the reference's
    ``_grad_scale``; ``stop_gradient`` at 0)."""
    if c == 1:
        return x
    return x.detach() if c == 0 else x.detach() + c * (x - x.detach())


def _cells_with_slopes(pos: torch.Tensor, res: int):
    """Per axis, without autograd: (base cell clipped to [0, res-1], offset
    clipped to [0, 1], d offset / d position), as ``_base_cells`` computes
    them. The slope is res inside the cell, res/2 on its faces (the
    reference's clip gradient at a tie) and 0 outside; the clip's second
    derivative is 0 everywhere."""
    out = []
    for a in range(3):
        s = pos[:, a].detach() * res
        i0 = torch.clamp(torch.floor(s).to(torch.int64), 0, res - 1)
        t = s - i0.to(torch.float32)
        inside, face = (t > 0) & (t < 1), (t == 0) | (t == 1)
        slope = torch.where(inside, float(res), torch.where(face, 0.5 * res, 0.0))
        out.append((i0, t.clamp(0.0, 1.0), slope))
    return out


def _stochastic_level(pos: torch.Tensor, res: int, hash_table_size: int, f: int):
    """One level of K1's geometry without autograd: the block's lanes (n,
    8F) and, per axis, the corner factors (parity 0, parity 1) and their
    derivatives in the position, (-slope, slope) on an even axis and 0 on
    an odd one (the coin's 0/1 weights). The same blocks and weights as
    ``_level_blocks``."""
    bs, dense_b = _block_level_layout(res, hash_table_size)
    bcoords, phi, dphi = [], [], []
    for (i0, o, slope), (p1, p2) in zip(_cells_with_slopes(pos, res), _COIN_PRIMES):
        odd = (i0 & 1) == 1
        up = _u01_hash(o, p1, p2) < o
        bcoords.append((i0 + (odd & up).to(torch.int64)) >> 1)
        upf = up.to(torch.float32)
        phi.append((torch.where(odd, upf, 1.0 - o), torch.where(odd, 1.0 - upf, o)))
        ds = torch.where(odd, 0.0, slope)
        dphi.append((-ds, ds))
    blk = _block_index(*bcoords, bs, dense_b, hash_table_size // 8)
    bpr = 16 // f
    return _block_lanes(blk // bpr, blk % bpr, f), phi, dphi


def _block_stochastic_twin_bwd_bwd(
    pos: torch.Tensor,
    table: torch.Tensor,
    grad: torch.Tensor,
    u: torch.Tensor,
    scales: Sequence[float],
    *,
    min_res: int,
    max_res: int,
    hash_table_size: int,
    need_grad: bool = True,
    need_table: bool = True,
    need_positions: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch K1bb: K1's backward (``_block_stochastic_twin_bwd``)
    differentiated again, for the cotangent ``u`` (n, 3) of its position
    gradient (the reference's autodiff of ``_row_gather_block_tw_bwd`` and
    ``_oh_bwd`` through ``block_level_geometry`` and ``_grad_scale``).

    Per (sample, level), with ``h_c = u . grad w8_c`` and ``a_c = sum_f g_f
    v_cf`` (v the bf16-rounded corner values): ``d_grad[l*F+f] = sum_c h_c
    v_cf`` (K1's forward with the weights h); the table lane of corner c,
    feature f gets ``scales[l] * h_c * g_f`` (K1's scatter with the weights
    h; nothing on a level of scale 0); the positions get ``sum_c a_c
    (hess w8_c) u``, whose only terms are the mixed partials of two even
    axes (w8 is a product of one factor per axis, each linear or constant).
    Returns (d_grad (n, L*F), d_table (L, S, 128), d_positions (n, 3)),
    each None unless asked, summed in ``dtype``: the card's oracle, its
    float64 reference and the CPU's path. The geometry stays float32."""
    L, S, lanes = table.shape
    F = 128 * S // hash_table_size
    n = pos.shape[0]
    dev = pos.device
    d_grad = torch.zeros((n, L * F), dtype=dtype, device=dev) if need_grad else None
    d_table = torch.zeros((L, S * lanes), dtype=dtype, device=dev) if need_table else None
    d_pos = torch.zeros((n, 3), dtype=dtype, device=dev) if need_positions else None
    u = u.detach().to(dtype)
    for l, res in enumerate(compute_level_resolutions(L, min_res, max_res)):
        table_l = need_table and bool(scales[l])
        if not (need_grad or table_l or need_positions):
            continue
        lanes_idx, phi, dphi = _stochastic_level(pos.detach(), int(res), hash_table_size, F)
        phi = [(a.to(dtype), b.to(dtype)) for a, b in phi]
        dphi = [(a.to(dtype), b.to(dtype)) for a, b in dphi]
        vals = _bf16(table[l].detach().reshape(-1)[lanes_idx]).to(dtype).view(n, 8, F)
        g = grad[:, l * F : (l + 1) * F].detach().to(dtype)
        h, second = [], []
        for c in range(8):
            bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            p = [phi[a][bits[a]] for a in range(3)]
            d = [dphi[a][bits[a]] for a in range(3)]
            h.append(u[:, 0] * d[0] * p[1] * p[2] + u[:, 1] * p[0] * d[1] * p[2] + u[:, 2] * p[0] * p[1] * d[2])
            second.append(torch.stack([
                d[0] * (d[1] * p[2] * u[:, 1] + p[1] * d[2] * u[:, 2]),
                d[1] * (d[0] * p[2] * u[:, 0] + p[0] * d[2] * u[:, 2]),
                d[2] * (d[0] * p[1] * u[:, 0] + p[0] * d[1] * u[:, 1]),
            ], dim=-1))
        h = torch.stack(h, dim=-1)  # (n, 8)
        if need_grad:
            d_grad[:, l * F : (l + 1) * F] = (h[:, :, None] * vals).sum(dim=1)
        if table_l:
            contrib = scales[l] * h[:, :, None] * g[:, None, :]
            d_table[l].index_add_(0, lanes_idx.reshape(-1), contrib.reshape(-1))
        if need_positions:
            a_c = (g[:, None, :] * vals).sum(dim=-1)  # (n, 8)
            d_pos += (a_c[:, :, None] * torch.stack(second, dim=1)).sum(dim=1)
    return d_grad, (None if d_table is None else d_table.view(L, S, lanes)), d_pos


def _exact_corner_lanes(ix0, iy0, iz0, *, bs, dense_b, nblocks, bpr, f) -> List[torch.Tensor]:
    """The first table lane of each of K3's eight corners (reference
    :696-729): vertex v = base + (dx, dy, dz) in block v >> 1 at parity v & 1."""
    lanes = []
    for corner in range(8):
        dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        vx, vy, vz = ix0 + dx, iy0 + dy, iz0 + dz
        blk = _block_index(vx >> 1, vy >> 1, vz >> 1, bs, dense_b, nblocks)
        parity = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1)
        lanes.append((blk // bpr) * 128 + (blk % bpr) * (8 * f) + parity * f)
    return lanes


def _block_exact_trilerp(table_l, ix0, iy0, iz0, ox, oy, oz, *, bs, dense_b, nblocks, bpr, f):
    """Plain PyTorch K3 for one level (reference :696-729): (n, f)."""
    flat = table_l.reshape(-1)
    feat = torch.arange(f, device=ox.device)
    acc = None
    lanes = _exact_corner_lanes(ix0, iy0, iz0, bs=bs, dense_b=dense_b, nblocks=nblocks, bpr=bpr, f=f)
    for corner, lane0 in enumerate(lanes):
        dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        w_c = (ox if dx else 1.0 - ox) * (oy if dy else 1.0 - oy) * (oz if dz else 1.0 - oz)
        part = w_c[:, None] * _bf16(flat[lane0[:, None] + feat])
        acc = part if acc is None else acc + part
    return acc


def _block_exact_twin(
    pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int, hash_table_size: int
) -> torch.Tensor:
    """Plain PyTorch K3: (n, 3) -> (n, L*F). Differentiable by autograd,
    the tests' second witness of K3b's twin."""
    L = table.shape[0]
    F = 128 * table.shape[1] // hash_table_size
    out = torch.empty((pos.shape[0], L * F), dtype=torch.float32, device=pos.device)
    for l, res in enumerate(compute_level_resolutions(L, min_res, max_res)):
        res = int(res)
        bs, dense_b = _block_level_layout(res, hash_table_size)
        (ix0, ox), (iy0, oy), (iz0, oz) = _base_cells(pos, res)
        out[:, l * F : (l + 1) * F] = _block_exact_trilerp(
            table[l], ix0, iy0, iz0, ox, oy, oz,
            bs=bs, dense_b=dense_b, nblocks=hash_table_size // 8, bpr=16 // F, f=F,
        )
    return out


def _block_exact_twin_bwd(
    pos: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, *, min_res: int, max_res: int,
    hash_table_size: int, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch K3b: K3's position gradient (n, 3) for the cotangent
    ``grad`` (n, L*F) (reference ``_block_exact_trilerp`` under
    ``jax.grad``), summed in ``dtype``. Per level and axis: ``d_o = sum_c
    (+-1) (the other two axes' weights) a_c`` with ``a_c = sum_f g_f v_cf``
    (v the bf16-rounded corner values), and ``d_x = d_o * slope``
    (``_cells_with_slopes``). The geometry stays float32."""
    L, S, _ = table.shape
    F = 128 * S // hash_table_size
    n = pos.shape[0]
    feat = torch.arange(F, device=pos.device)
    d_pos = torch.zeros((n, 3), dtype=dtype, device=pos.device)
    for l, res in enumerate(compute_level_resolutions(L, min_res, max_res)):
        res = int(res)
        bs, dense_b = _block_level_layout(res, hash_table_size)
        cells = _cells_with_slopes(pos, res)
        lanes = _exact_corner_lanes(*(c[0] for c in cells), bs=bs, dense_b=dense_b, nblocks=hash_table_size // 8,
                                    bpr=16 // F, f=F)
        w = [(1.0 - o.to(dtype), o.to(dtype)) for _, o, _ in cells]
        flat = table[l].detach().reshape(-1)
        g = grad[:, l * F : (l + 1) * F].detach().to(dtype)
        d_o = [torch.zeros((n,), dtype=dtype, device=pos.device) for _ in range(3)]
        for c, lane0 in enumerate(lanes):
            a_c = (g * _bf16(flat[lane0[:, None] + feat]).to(dtype)).sum(dim=-1)
            bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            for a in range(3):
                b1, b2 = [b for b in range(3) if b != a]
                term = a_c * w[b1][bits[b1]] * w[b2][bits[b2]]
                d_o[a] = d_o[a] + term if bits[a] else d_o[a] - term
        for a in range(3):
            d_pos[:, a] += d_o[a] * cells[a][2].to(dtype)
    return d_pos


_LIB: Optional[ctypes.CDLL] = None


@functools.lru_cache(maxsize=None)
def _u32_divisor(d: int) -> Tuple[int, int]:
    """(magic, shift) with which the lane kernels divide a uint32 ``x`` by
    ``d`` without a divide instruction. A power of two d = 2^shift gives
    magic 0: ``x >> shift`` and ``x & (d - 1)``. Otherwise shift =
    ceil(log2 d), magic = floor(2^32 (2^shift - d) / d) + 1 < 2^32 (the
    round-up multiplier 2^32 + magic, one bit too wide for 32), and
    ``x // d == (t + ((x - t) >> 1)) >> (shift - 1)`` with ``t = (x * magic)
    >> 32`` for every x < 2^32. The hash is a full uint32, so the 31-bit
    magic of ``gather_probes._divisor_magic`` does not cover it."""
    if not 1 <= d < 2**32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    shift = (d - 1).bit_length()
    if d & (d - 1) == 0:
        return 0, shift
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _pick_design(features: int, design: Optional[str] = None) -> str:
    """The design of a kernel at ``features`` per level: ``design``,
    checked, or the default."""
    if design is None:
        return _DEFAULT if features in _LANE_WIDTHS else "per-thread"
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {list(DESIGNS)}")
    if design != "per-thread" and features not in _LANE_WIDTHS:
        raise ValueError(f"the {design} design takes F in {_LANE_WIDTHS}, got F={features}")
    return design


def _private_floats(res: int, hash_table_size: int, features: int) -> Optional[int]:
    """Floats of one level's table-gradient copy in K7's private pass, or
    None for a hashed level: a dense level's (res+1)^3 entries of F floats,
    rounded up to a multiple of 4 (the pass stores 16 bytes at a time). The
    CUDA entry counts the same (make_bwd_levels) and refuses a mismatch."""
    side = res + 1
    return -(-(side**3) * features // 4) * 4 if side**3 <= hash_table_size else None


def bwd_plan(resolutions: Sequence[int], hash_table_size: int, features: int) -> Tuple[Tuple[int, ...], int]:
    """The levels whose table gradient K7's private pass reduces in shared
    memory when the table gradient alone is asked, and the shared bytes one
    of its blocks takes: every dense level, coarse first, whose copy fits
    ``SHARED_BYTES_PER_BLOCK`` together with those picked before it. The
    CUDA entry refuses a plan that this function does not give."""
    picked, total = [], 0
    for l, res in enumerate(resolutions):
        f = _private_floats(int(res), hash_table_size, features)
        if f is not None and total + 4 * f <= SHARED_BYTES_PER_BLOCK:
            picked.append(l)
            total += 4 * f
    return tuple(picked), total


def _check_lane_limits(table: torch.Tensor, n: int, *tensors: Optional[torch.Tensor]) -> None:
    """The lane kernels' 32-bit limits and alignment: the table and each of
    ``tensors`` (None: not passed) 16-byte aligned."""
    if any(t is not None and t.data_ptr() % 16 for t in (table, *tensors)):
        raise ValueError("the lane-group kernels take a 16-byte aligned table, table gradient and cotangents")
    L = table.shape[0]
    if n * L >= 2**31 or table.numel() >= 2**32:
        raise ValueError(f"the lane-group kernels take n * num_levels < 2^31 and a table of fewer than 2^32 "
                         f"floats, got {n} * {L} and {table.numel()}")


def _kernel_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from nerfstudio_torch.ops import cuda_build

        lib = cuda_build.load("hash_grid")
        geometry = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_int)]
        lib.nst_hash_encode_block.argtypes = (
            [ctypes.c_void_p] * 3 + geometry + [ctypes.c_int, ctypes.c_int] + [ctypes.c_uint] * 4 + [ctypes.c_void_p]
        )
        lib.nst_hash_encode_block.restype = ctypes.c_int
        # scales, design, divisor (magic, shift), stream
        lib.nst_hash_encode_block_bwd.argtypes = (
            [ctypes.c_void_p] * 5 + geometry + [ctypes.POINTER(ctypes.c_float), ctypes.c_int] + [ctypes.c_uint] * 2
            + [ctypes.c_void_p]
        )
        lib.nst_hash_encode_block_bwd.restype = ctypes.c_int
        # design, divisors (magic, shift) of L and T, stream
        lib.nst_hash_encode_flat.argtypes = (
            [ctypes.c_void_p] * 3 + geometry + [ctypes.c_int] + [ctypes.c_uint] * 4 + [ctypes.c_void_p]
        )
        lib.nst_hash_encode_flat.restype = ctypes.c_int
        # design, private level mask, shared bytes, private-pass scratch and
        # block count, divisor (magic, shift), stream
        lib.nst_hash_encode_flat_bwd.argtypes = [ctypes.c_void_p] * 5 + geometry + [
            ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_void_p]
        lib.nst_hash_encode_flat_bwd.restype = ctypes.c_int
        # K3b: pos, table, grad, d_pos, geometry, design, divisor (magic, shift), stream
        lib.nst_hash_encode_block_exact_bwd.argtypes = (
            [ctypes.c_void_p] * 4 + geometry + [ctypes.c_int] + [ctypes.c_uint] * 2 + [ctypes.c_void_p]
        )
        lib.nst_hash_encode_block_exact_bwd.restype = ctypes.c_int
        # K1bb: pos, table, grad, u, d_grad, d_table, d_pos, geometry, scales, design, divisor, stream
        lib.nst_hash_encode_block_bwd_bwd.argtypes = (
            [ctypes.c_void_p] * 7 + geometry + [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            + [ctypes.c_uint] * 2 + [ctypes.c_void_p]
        )
        lib.nst_hash_encode_block_bwd_bwd.restype = ctypes.c_int
        lib.nst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nst_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, fn, pos: torch.Tensor, *args) -> None:
    """Call a kernel's C entry on the current stream of ``pos``'s device,
    raise on a refused launch, and count it in ``launch_counts``."""
    lib = _kernel_library()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.nst_cuda_error_string(err).decode()}")
    launch_counts[name] += 1


def _geometry_args(table: torch.Tensor, n: int, min_res: int, max_res: int, hash_table_size: int):
    L, S, _ = table.shape
    res = compute_level_resolutions(L, min_res, max_res)
    return (n, L, 128 * S // hash_table_size, S, hash_table_size, (ctypes.c_int * L)(*[int(r) for r in res]))


def _block_kernel(
    pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int,
    hash_table_size: int, exact: bool, _design: Optional[str] = None,
) -> torch.Tensor:
    """Launch the CUDA forward kernel (K3 if ``exact`` else K1) in its
    default design, or in ``_design`` (one of ``DESIGNS``), which only
    chip_smoke.py's comparison of the designs sets."""
    L, S, _ = table.shape
    n = pos.shape[0]
    F = 128 * S // hash_table_size
    design = _pick_design(F, _design)
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    if design != "per-thread":
        _check_lane_limits(table, n)
    _launch(
        "hash_encode_block_exact" if exact else "hash_encode_block", "nst_hash_encode_block", pos,
        pos.data_ptr(), table.data_ptr(), out.data_ptr(),
        *_geometry_args(table, n, min_res, max_res, hash_table_size), int(exact), DESIGNS[design],
        *_u32_divisor(L), *_u32_divisor(hash_table_size // 8),
    )
    if design == "per-thread":
        launch_counts["hash_encode_block_per_thread"] += 1
    return out


def _bwd_launch_plan(design: str, table: torch.Tensor, d_table: Optional[torch.Tensor], n: int, min_res: int,
                     max_res: int, hash_table_size: int, privatise: bool = False):
    """(design code, private level mask, shared bytes) of a backward launch
    in ``design``, with ``bwd_plan``'s levels if ``privatise`` (K7 asked for
    the table gradient alone) and the design is the lane groups; checks the
    lane kernels' limits."""
    code = DESIGNS[design]
    if not code:
        return 0, 0, 0
    _check_lane_limits(table, n, *([] if d_table is None else [d_table]))
    if not privatise:
        return code, 0, 0
    L, S, _ = table.shape
    return (code, *_private_mask(L, min_res, max_res, hash_table_size, 128 * S // hash_table_size))


@functools.lru_cache(maxsize=None)
def _private_mask(L: int, min_res: int, max_res: int, hash_table_size: int, features: int) -> Tuple[int, int]:
    """``bwd_plan``'s levels as a bit mask, and its bytes, for one shape
    (cached: a training step asks the same twice per step)."""
    levels, nbytes = bwd_plan(compute_level_resolutions(L, min_res, max_res), hash_table_size, features)
    return sum(1 << l for l in levels), nbytes


def _private_scratch(pos: torch.Tensor, nbytes: int) -> Tuple[Optional[torch.Tensor], int]:
    """The private pass's scratch, one slab of ``nbytes`` per SM, and the
    slab count; the CUDA entry launches one block per slab or fewer (none
    with less than one sample per thread). (None, 0) without privatised
    levels."""
    if not nbytes:
        return None, 0
    sms = torch.cuda.get_device_properties(pos.device).multi_processor_count
    return torch.empty(sms * nbytes // 4, dtype=torch.float32, device=pos.device), sms


def _block_bwd_kernel(
    pos: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, scales: Sequence[float], *,
    min_res: int, max_res: int, hash_table_size: int, need_positions: bool = True, need_table: bool = True,
    _design: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the CUDA K1 backward in its default design, or in ``_design``
    (one of ``DESIGNS``, which only chip_smoke.py's comparison of the
    designs sets): (d_table or None, d_positions or None)."""
    n = pos.shape[0]
    L, S, _ = table.shape
    design = _pick_design(128 * S // hash_table_size, _design)
    d_table = torch.zeros_like(table) if need_table else None
    d_pos = torch.empty_like(pos) if need_positions else None
    if n == 0 or not (need_table or need_positions):
        return d_table, d_pos
    if grad.shape != (n, L * (128 * S // hash_table_size)) or grad.dtype != torch.float32:
        raise ValueError(f"grad must be float32 ({n}, L*F), got {grad.dtype} {tuple(grad.shape)}")
    code, _, _ = _bwd_launch_plan(design, table, d_table, n, min_res, max_res, hash_table_size)
    _launch(
        "hash_encode_block_bwd", "nst_hash_encode_block_bwd", pos,
        pos.data_ptr(), table.data_ptr(), grad.contiguous().data_ptr(),
        d_table.data_ptr() if need_table else None, d_pos.data_ptr() if need_positions else None,
        *_geometry_args(table, n, min_res, max_res, hash_table_size),
        (ctypes.c_float * L)(*[float(s) for s in scales]), code, *_u32_divisor(hash_table_size // 8),
    )
    if design == "per-thread":
        launch_counts["hash_encode_bwd_per_thread"] += 1
    return d_table, d_pos


def _check_cotangent(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.shape != shape or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")


def _block_exact_bwd_kernel(
    pos: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, *, min_res: int, max_res: int, hash_table_size: int,
    _design: Optional[str] = None,
) -> torch.Tensor:
    """Launch the CUDA K3b: K3's position gradient (n, 3) for the cotangent
    ``grad`` (n, L*F), in its default design or in ``_design`` (one of
    ``DESIGNS``, which only chip_smoke.py's comparison of the designs sets).
    It indexes in 32 bits in both designs."""
    n = pos.shape[0]
    L = table.shape[0]
    F = _features(table, hash_table_size)
    design = _pick_design(F, _design)
    d_pos = torch.empty_like(pos)
    if n == 0:
        return d_pos
    _check_cotangent("grad", grad, (n, L * F))
    grad = grad.contiguous()
    _check_lane_limits(table, n, *([grad] if design != "per-thread" else []))
    _launch("hash_encode_block_exact_bwd", "nst_hash_encode_block_exact_bwd", pos,
            pos.data_ptr(), table.data_ptr(), grad.data_ptr(), d_pos.data_ptr(),
            *_geometry_args(table, n, min_res, max_res, hash_table_size), DESIGNS[design],
            *_u32_divisor(hash_table_size // 8))
    if design == "per-thread":
        launch_counts["hash_encode_normals_per_thread"] += 1
    return d_pos


def _block_bwd_bwd_kernel(
    pos: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, u: torch.Tensor, scales: Sequence[float], *,
    min_res: int, max_res: int, hash_table_size: int, need_grad: bool = True, need_table: bool = True,
    need_positions: bool = True, _design: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the CUDA K1bb (``_block_stochastic_twin_bwd_bwd``'s math) for
    the cotangent ``u`` (n, 3) of K1 backward's position gradient, in its
    default design or in ``_design`` (as ``_block_exact_bwd_kernel``):
    (d_grad (n, L*F), d_table (L, S, 128), d_positions (n, 3)), each None
    unless asked. The table gradient is summed with float32 atomics into a
    zeroed buffer. It indexes in 32 bits in both designs."""
    n = pos.shape[0]
    L = table.shape[0]
    F = _features(table, hash_table_size)
    design = _pick_design(F, _design)
    d_grad = torch.empty_like(grad) if need_grad else None
    d_table = torch.zeros_like(table) if need_table else None
    d_pos = torch.empty_like(pos) if need_positions else None
    if n == 0 or not (need_grad or need_table or need_positions):
        return d_grad, d_table, d_pos
    _check_cotangent("grad", grad, (n, L * F))
    _check_cotangent("u", u, (n, 3))
    grad, u = grad.contiguous(), u.contiguous()
    _check_lane_limits(table, n, d_table, *([grad, u, d_grad] if design != "per-thread" else []))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch(
        "hash_encode_block_bwd_bwd", "nst_hash_encode_block_bwd_bwd", pos,
        pos.data_ptr(), table.data_ptr(), grad.data_ptr(), u.data_ptr(), ptr(d_grad),
        ptr(d_table), ptr(d_pos), *_geometry_args(table, n, min_res, max_res, hash_table_size),
        (ctypes.c_float * L)(*[float(s) for s in scales]), DESIGNS[design], *_u32_divisor(hash_table_size // 8),
    )
    if design == "per-thread":
        launch_counts["hash_encode_normals_per_thread"] += 1
    return d_grad, d_table, d_pos


def _engine_needs(ctx, i: int) -> bool:
    """Whether the backward pass now running reads the gradient of the
    Function's ``i``-th input (a tensor input: each Function here takes its
    tensors first). ``ctx.needs_input_grad`` says only that the input
    requires one; ``torch.autograd.grad`` with ``inputs`` runs only the
    nodes that reach them. So the normals' position gradient, taken with
    the table a parameter, scatters no table gradient, as the reference's
    dead-code elimination drops it. Under ``torch.autograd.grad`` torch
    refuses the query for a leaf that is one of the ``inputs`` (it answers
    False for the other leaves): such a leaf's gradient is read."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None:
        return False
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:
        return True


class _BlockEncode(torch.autograd.Function):
    """K1 forward. ``scales`` is the per-level factor on the table gradient
    (0 on levels outside ``bwd_levels``). The backward is ``_BlockEncodeBwd``,
    a Function of its own: under ``create_graph=True`` its gradients carry a
    graph whose backward is K1bb, on the card and on the CPU alike."""

    @staticmethod
    def forward(ctx, pos, table, scales, geom):
        ctx.save_for_backward(pos, table)
        ctx.scales, ctx.geom = scales, geom
        if pos.device.type == "cuda":
            return _block_kernel(pos, table, exact=False, **geom)
        return _block_stochastic_twin(pos, table, **geom)

    @staticmethod
    def backward(ctx, grad):
        pos, table = ctx.saved_tensors
        need_pos, need_table = _engine_needs(ctx, 0), _engine_needs(ctx, 1)
        if not (need_pos or need_table):
            return None, None, None, None
        d_pos, d_table = _BlockEncodeBwd.apply(pos, table, grad.contiguous(), ctx.scales, ctx.geom, need_pos,
                                               need_table)
        return d_pos, d_table, None, None


class _BlockEncodeBwd(torch.autograd.Function):
    """K1's backward (K1 bwd with K2) as a function of (positions, table,
    the encoding's cotangent) -> (d_positions, d_table), each None unless
    asked; its backward is K1bb for the cotangent of d_positions, once
    differentiable. No reference path differentiates the table gradient,
    so a cotangent of d_table raises."""

    @staticmethod
    def forward(ctx, pos, table, grad, scales, geom, need_pos, need_table):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pos, table, grad)
        ctx.scales, ctx.geom = scales, geom
        if pos.device.type == "cuda":
            d_table, d_pos = _block_bwd_kernel(pos, table, grad, scales, need_positions=need_pos,
                                               need_table=need_table, **geom)
        else:
            d_table, d_pos = _block_stochastic_twin_bwd(
                pos, table, grad, scales if need_table else [0.0] * len(scales), need_positions=need_pos, **geom
            )
        return d_pos, (d_table if need_table else None)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u_pos, u_table):
        if u_table is not None:
            raise NotImplementedError(
                "K1's table gradient has no derivative here: the reference differentiates only the position "
                "gradient of its backward (the density-gradient normals)")
        nones = (None,) * 4
        if u_pos is None:
            return (None, None, None) + nones
        pos, table, grad = ctx.saved_tensors
        need = dict(need_positions=_engine_needs(ctx, 0), need_table=_engine_needs(ctx, 1),
                    need_grad=_engine_needs(ctx, 2))
        bwd_bwd = _block_bwd_bwd_kernel if pos.device.type == "cuda" else _block_stochastic_twin_bwd_bwd
        d_grad, d_table, d_pos = bwd_bwd(pos, table, grad, u_pos.contiguous(), ctx.scales, **need, **ctx.geom)
        return (d_pos, d_table, d_grad) + nones


class _BlockExactEncode(torch.autograd.Function):
    """K3 forward and its position gradient K3b, once differentiable. The
    reference takes K3's gradient in the positions alone (the eval
    normals), so a table gradient through K3 raises."""

    @staticmethod
    def forward(ctx, pos, table, geom):
        ctx.save_for_backward(pos, table)
        ctx.geom = geom
        if pos.device.type == "cuda":
            return _block_kernel(pos, table, exact=True, **geom)
        return _block_exact_twin(pos, table, **geom)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        if _engine_needs(ctx, 1):
            raise NotImplementedError("K3 (block_exact) has no table gradient: only the positions' is ported")
        if not _engine_needs(ctx, 0):
            return None, None, None
        pos, table = ctx.saved_tensors
        bwd = _block_exact_bwd_kernel if pos.device.type == "cuda" else _block_exact_twin_bwd
        return bwd(pos, table, grad.contiguous(), **ctx.geom), None, None


# --------------------------------------------------------------------------
# K7: the flat layout (reference ``hash_encode``'s 8-corner path, :991-1031,
# through ``_row_gather_select`` :62-107 and ``_hash_corner`` :732). Entry e
# of level l holds its F features at ``table[l].reshape(-1)[e*F : e*F + F]``.
# Per level: s = x*res, the base vertex floor(s), the offset s - floor(s)
# (not clipped: its derivative is res everywhere); corners c = dx<<2 | dy<<1
# | dz in the order 0..7, each indexed densely ((cx*side + cy)*side + cz
# with coordinates clipped to [0, side-1], side = res+1) when side^3 <= T
# and hashed otherwise; the value of a corner is its table entry rounded to
# bf16, weighted by ((wx*wy)*wz). The backward scatters w_c*g into the
# table in float32 and carries d_w_c = <g, bf16 value> to the positions.


def _features(table: torch.Tensor, hash_table_size: int) -> int:
    return 128 * table.shape[1] // hash_table_size


def _level_corners(pos: torch.Tensor, res: int, hash_table_size: int, dtype=torch.float32):
    """One level: (entries (n, 8) int64, per-axis weights [(w0, w1)] * 3 in
    ``dtype``). The offsets are computed in float32 whatever ``dtype`` is,
    so a float64 run indexes the same corners."""
    side = res + 1
    dense = side**3 <= hash_table_size
    base, weights = [], []
    for a in range(3):
        s = pos[:, a] * res
        fl = torch.floor(s)
        base.append(fl.to(torch.int64))
        o = (s - fl).to(dtype)
        weights.append((1.0 - o, o))
    entries = []
    for c in range(8):
        v = [base[a] + ((c >> (2 - a)) & 1) for a in range(3)]
        if dense:
            v = [torch.clamp(x, 0, side - 1) for x in v]
            entries.append((v[0] * side + v[1]) * side + v[2])
        else:
            entries.append(_hash_corner(*v, hash_table_size))
    return torch.stack(entries, dim=-1), weights


def _corner_weight(weights, c: int) -> torch.Tensor:
    (wx, wy, wz) = weights
    return wx[(c >> 2) & 1] * wy[(c >> 1) & 1] * wz[c & 1]


def _flat_twin(pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int,
               hash_table_size: int) -> torch.Tensor:
    """Plain PyTorch K7 forward: (n, 3) -> (n, L*F), summed in the
    reference's order."""
    L = table.shape[0]
    F = _features(table, hash_table_size)
    feat = torch.arange(F, device=pos.device)
    out = torch.empty((pos.shape[0], L * F), dtype=torch.float32, device=pos.device)
    for l, res in enumerate(compute_level_resolutions(L, min_res, max_res)):
        entries, weights = _level_corners(pos, int(res), hash_table_size)
        vals = _bf16(table[l].reshape(-1)[entries[:, :, None] * F + feat])  # (n, 8, F)
        acc = _corner_weight(weights, 0)[:, None] * vals[:, 0]
        for c in range(1, 8):
            acc = acc + _corner_weight(weights, c)[:, None] * vals[:, c]
        out[:, l * F : (l + 1) * F] = acc
    return out


def _flat_twin_bwd(
    pos: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, *, min_res: int, max_res: int,
    hash_table_size: int, need_positions: bool = True, need_table: bool = True, dtype: torch.dtype = torch.float32,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch K7 backward in ``dtype``: (d_table (L, S, 128) or None,
    d_positions (n, 3) or None) for the cotangent ``grad`` (n, L*F)."""
    L, S, lanes = table.shape
    F = _features(table, hash_table_size)
    n = pos.shape[0]
    feat = torch.arange(F, device=pos.device)
    d_table = torch.zeros((L, S * lanes), dtype=dtype, device=pos.device) if need_table else None
    d_pos = torch.zeros((n, 3), dtype=dtype, device=pos.device) if need_positions else None
    for l, res in enumerate(compute_level_resolutions(L, min_res, max_res)):
        entries, weights = _level_corners(pos, int(res), hash_table_size, dtype)
        w8 = torch.stack([_corner_weight(weights, c) for c in range(8)], dim=-1)  # (n, 8)
        lanes_idx = entries[:, :, None] * F + feat
        g = grad[:, l * F : (l + 1) * F].to(dtype)
        if need_table:
            d_table[l].index_add_(0, lanes_idx.reshape(-1), (w8[:, :, None] * g[:, None, :]).reshape(-1))
        if need_positions:
            vals = _bf16(table[l].reshape(-1)[lanes_idx]).to(dtype)
            d_w8 = (g[:, None, :] * vals).sum(dim=-1)  # (n, 8)
            for a in range(3):
                b1, b2 = [b for b in range(3) if b != a]
                d_o = torch.zeros((n,), dtype=dtype, device=pos.device)
                for c in range(8):
                    other = weights[b1][(c >> (2 - b1)) & 1] * weights[b2][(c >> (2 - b2)) & 1]
                    term = d_w8[:, c] * other
                    d_o = d_o + term if (c >> (2 - a)) & 1 else d_o - term
                d_pos[:, a] += d_o * res
    return (None if d_table is None else d_table.view(L, S, lanes)), d_pos


def _flat_kernel(pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int, hash_table_size: int,
                 _design: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA K7 forward in its default design, or in ``_design``
    (one of ``DESIGNS``), which only chip_smoke.py's comparison of the
    designs sets."""
    n = pos.shape[0]
    L = table.shape[0]
    F = _features(table, hash_table_size)
    design = _pick_design(F, _design)
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    if design != "per-thread":
        _check_lane_limits(table, n)
    _launch("hash_encode_flat", "nst_hash_encode_flat", pos, pos.data_ptr(), table.data_ptr(), out.data_ptr(),
            *_geometry_args(table, n, min_res, max_res, hash_table_size), DESIGNS[design],
            *_u32_divisor(L), *_u32_divisor(hash_table_size))
    if design == "per-thread":
        launch_counts["hash_encode_flat_per_thread"] += 1
    return out


def _flat_bwd_kernel(
    pos: torch.Tensor, table: torch.Tensor, grad: torch.Tensor, *, min_res: int, max_res: int,
    hash_table_size: int, need_positions: bool = True, need_table: bool = True, _design: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the CUDA K7 backward in its default design, or in ``_design``
    (one of ``DESIGNS``, set only by chip_smoke.py): (d_table or None,
    d_positions or None). The lane groups privatise ``bwd_plan``'s levels
    when the table gradient alone is asked (a neus-facto step's case); with
    the position gradient, which walks every level anyway, they do not
    (PERF.md records both)."""
    n = pos.shape[0]
    L = table.shape[0]
    design = _pick_design(_features(table, hash_table_size), _design)
    d_table = torch.zeros_like(table) if need_table else None
    d_pos = torch.empty_like(pos) if need_positions else None
    if n == 0 or not (need_table or need_positions):
        return d_table, d_pos
    if grad.shape != (n, L * _features(table, hash_table_size)) or grad.dtype != torch.float32:
        raise ValueError(f"grad must be float32 ({n}, L*F), got {grad.dtype} {tuple(grad.shape)}")
    plan = _bwd_launch_plan(design, table, d_table, n, min_res, max_res, hash_table_size,
                            privatise=need_table and not need_positions)
    scratch, blocks = _private_scratch(pos, plan[2])
    _launch(
        "hash_encode_flat_bwd", "nst_hash_encode_flat_bwd", pos,
        pos.data_ptr(), table.data_ptr(), grad.contiguous().data_ptr(),
        d_table.data_ptr() if need_table else None, d_pos.data_ptr() if need_positions else None,
        *_geometry_args(table, n, min_res, max_res, hash_table_size), *plan,
        scratch.data_ptr() if blocks else None, blocks, *_u32_divisor(hash_table_size),
    )
    if design == "per-thread":
        launch_counts["hash_encode_bwd_per_thread"] += 1
    return d_table, d_pos


class _FlatEncode(torch.autograd.Function):
    """K7 forward and backward, once differentiable: the reference
    differentiates K7 (neus-facto's proposal nets) once only."""

    @staticmethod
    def forward(ctx, pos, table, geom):
        ctx.save_for_backward(pos, table)
        ctx.geom = geom
        if pos.device.type == "cuda":
            return _flat_kernel(pos, table, **geom)
        return _flat_twin(pos, table, **geom)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        pos, table = ctx.saved_tensors
        need_pos, need_table = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        grad = grad.contiguous()
        bwd = _flat_bwd_kernel if pos.device.type == "cuda" else _flat_twin_bwd
        d_table, d_pos = bwd(pos, table, grad, need_positions=need_pos, need_table=need_table, **ctx.geom)
        return d_pos, d_table, None


def _check_inputs(positions: torch.Tensor, table: torch.Tensor, num_levels: int, hash_table_size: int) -> None:
    """Validate shapes, types, devices and layout."""
    if positions.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"hash_encode takes float32, got {positions.dtype} and {table.dtype}")
    if positions.shape[-1] != 3:
        raise ValueError(f"positions must be (..., 3), got {tuple(positions.shape)}")
    if table.ndim != 3 or table.shape[0] != num_levels or table.shape[2] != 128:
        raise ValueError(f"table must be ({num_levels}, S, 128), got {tuple(table.shape)}")
    if positions.device != table.device:
        raise ValueError(f"positions on {positions.device}, table on {table.device}")
    if positions.device.type not in ("cuda", "cpu"):
        raise ValueError(f"hash_encode runs on cuda or cpu tensors, got {positions.device}")
    if not (positions.is_contiguous() and table.is_contiguous()):
        raise ValueError("hash_encode takes contiguous positions and table")
    S = table.shape[1]
    if hash_table_size % 8 or (128 * S) % hash_table_size:
        raise ValueError(f"table rows {S} do not match hash_table_size {hash_table_size}")
    F = 128 * S // hash_table_size
    if F not in (1, 2, 4, 8, 16):
        raise ValueError(f"features_per_level {F} must be 1, 2, 4, 8 or 16")


def hash_encode(
    positions: torch.Tensor,
    table: torch.Tensor,
    *,
    num_levels: int,
    min_res: int,
    max_res: int,
    hash_table_size: int,
    block: bool = False,
    block_exact: bool = False,
    bwd_levels: Optional[Sequence[int]] = None,
    bwd_scale: float = 1.0,
) -> torch.Tensor:
    """Encode positions in [0,1]^3 (reference :755-1044).

    positions: (..., 3) float32; table: (num_levels, S, 128) float32 with
    S = hash_table_size * F / 128. Returns (..., num_levels * F) float32,
    column order l*F + f. ``block_exact`` takes K3, ``block`` alone takes K1,
    neither takes the flat layout (K7). CUDA tensors launch the kernels, CPU
    tensors run the twins.

    On the card, the forward of K1 and K7 and K3 at F = 2 or 4 (every
    shipped config) take the lane-group kernels, which index in 32 bits:
    they take fewer than 2^31 (sample, level) pairs, a table of fewer than
    2^32 floats, 16-byte aligned, and raise ValueError otherwise. The backward of K1 and
    of K7 at F = 2 or 4 takes the same limits (its table gradient is
    allocated aligned): lane groups with vector reductions; K7, asked for
    the table gradient alone, first reduces the dense coarse levels whose
    gradient fits one block's shared memory (``bwd_plan``).

    ``bwd_levels`` (K1 only): the levels whose table gets a gradient, scaled
    by ``bwd_scale``; the other levels get none. None gives every level an
    unscaled gradient. Position gradients flow on every level either way.

    K1 is differentiable twice (its position gradient's own gradient,
    K1bb, reaches the table on the levels of ``bwd_levels`` at the same
    scale), K3 once in the positions (K3b), K7 once."""
    _check_inputs(positions, table, num_levels, hash_table_size)
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    geom = dict(min_res=min_res, max_res=max_res, hash_table_size=hash_table_size)
    if not (block or block_exact):
        if bwd_levels is not None:
            raise ValueError("bwd_levels is a block-layout (K1) option")
        out = _FlatEncode.apply(pos, table, geom)
    elif block_exact:
        out = _BlockExactEncode.apply(pos, table, geom)
    else:
        if bwd_levels is None:
            scales = (1.0,) * num_levels
        else:
            scales = tuple(float(bwd_scale) if l in bwd_levels else 0.0 for l in range(num_levels))
        out = _BlockEncode.apply(pos, table, scales, geom)
    return out.reshape(batch_shape + (out.shape[-1],))


def init_hash_table(
    num_levels: int, hash_table_size: int, features_per_level: int, scale: float = 1e-4, device=None
) -> torch.Tensor:
    """Uniform(-scale, scale) table in the (L, S, 128) layout (reference
    :1047-1071), on ``device`` (None: the GPU, ``utils.device``)."""
    if 128 % features_per_level or hash_table_size % (128 // features_per_level):
        raise ValueError(
            f"features_per_level {features_per_level} must divide 128 and 128/F must divide "
            f"hash_table_size {hash_table_size}"
        )
    table = torch.empty(
        (num_levels, hash_table_size * features_per_level // 128, 128), dtype=torch.float32,
        device=resolve_device(device),
    )
    return table.uniform_(-scale, scale)
