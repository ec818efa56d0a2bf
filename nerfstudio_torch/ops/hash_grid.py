"""Multiresolution hash-grid encoding (Instant-NGP), block-packed layout,
forward only.

Counterpart of ``nerfstudio_tpu/ops/hash_grid.py``. Tables keep the JAX
package's ``(L, S, 128)`` float32 layout, so JAX tables load without
repacking. Two paths are ported:

* ``hash_encode(block=True)`` (K1 forward): one 2x2x2 vertex block per
  (sample, level), odd axes rounded stochastically from a hash of the cell
  offset's float bits;
* ``hash_encode(block_exact=True)`` (K3): the exact 8-corner trilerp through
  the same layout.

Each dispatches on the device of its inputs: CUDA tensors go to the
hand-written kernel in ``csrc/hash_grid.cu`` (or the call raises), CPU
tensors go to the plain PyTorch twin in this module. The flat layout (K7),
the one-corner and z-pair paths and every backward are not ported.

Integer hashing runs on int64 with the uint32 wrap made explicit
(``_mul32``), so the twin reproduces the reference's uint32 arithmetic
bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# odd-axis coin multipliers per axis (reference block_level_geometry)
_COIN_PRIMES = (
    (0x85EBCA6B, 0x9E3779B1),
    (0xC2B2AE35, 0x27D4EB2F),
    (0x165667B1, 0xD3A2646C),
)

# Launches of each hand-written kernel, counted where the kernel is launched.
launch_counts: Dict[str, int] = {"hash_encode_block": 0, "hash_encode_block_exact": 0}


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
    b = o.contiguous().view(torch.int32).to(torch.int64) & _MASK32
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


def _base_cells(positions: torch.Tensor, res: int):
    """Per axis: base cell clipped to [0, res-1] and its offset in [0, 1]."""
    cells = []
    for a in range(3):
        s = positions[:, a] * res
        i0 = torch.clamp(torch.floor(s).to(torch.int64), 0, res - 1)
        o = torch.clamp(s - i0.to(torch.float32), 0.0, 1.0)
        cells.append((i0, o))
    return cells


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
    bpr = epr // 8
    nblocks = hash_table_size // 8
    out = []
    for res in compute_level_resolutions(num_levels, min_res, max_res):
        res = int(res)
        bs, dense_b = _block_level_layout(res, hash_table_size)
        bcoords, pweights = [], []
        for (i0, o), (p1, p2) in zip(_base_cells(positions, res), _COIN_PRIMES):
            odd = (i0 & 1) == 1
            up = _u01_hash(o, p1, p2) < o
            # block of the chosen vertex on odd axes, of the base on even ones
            bcoords.append((i0 + (odd & up).to(torch.int64)) >> 1)
            upf = up.to(torch.float32)
            pweights.append(
                (torch.where(odd, upf, 1.0 - o), torch.where(odd, 1.0 - upf, o))
            )
        blk = _block_index(*bcoords, bs, dense_b, nblocks)
        (wx0, wx1), (wy0, wy1), (wz0, wz1) = pweights
        w8 = torch.stack(
            [
                (wx1 if (c >> 2) & 1 else wx0)
                * (wy1 if (c >> 1) & 1 else wy0)
                * (wz1 if c & 1 else wz0)
                for c in range(8)
            ],
            dim=-1,
        )
        out.append((blk // bpr, blk % bpr, w8))
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back: the table read precision."""
    return x.to(torch.bfloat16).to(torch.float32)


def _block_stochastic_twin(
    pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int, hash_table_size: int
) -> torch.Tensor:
    """Plain PyTorch K1 forward: (n, 3) -> (n, L*F)."""
    L, _, lanes = table.shape
    F = 128 * table.shape[1] // hash_table_size
    n = pos.shape[0]
    geom = block_level_geometry(
        pos, num_levels=L, min_res=min_res, max_res=max_res,
        hash_table_size=hash_table_size, features_per_level=F,
    )
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    corner_lanes = torch.arange(8 * F, device=pos.device)
    for l, (rows, slot, w8) in enumerate(geom):
        lane0 = rows * lanes + slot * (8 * F)
        vals = _bf16(table[l].reshape(-1)[lane0[:, None] + corner_lanes]).view(n, 8, F)
        out[:, l * F : (l + 1) * F] = (w8[:, :, None] * vals).sum(dim=1)
    return out


def _block_exact_trilerp(table_l, ix0, iy0, iz0, ox, oy, oz, *, bs, dense_b, nblocks, bpr, f):
    """Plain PyTorch K3 for one level (reference :696-729): (n, f)."""
    flat = table_l.reshape(-1)
    feat = torch.arange(f, device=ox.device)
    acc = None
    for corner in range(8):
        dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        vx, vy, vz = ix0 + dx, iy0 + dy, iz0 + dz
        blk = _block_index(vx >> 1, vy >> 1, vz >> 1, bs, dense_b, nblocks)
        parity = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1)
        w_c = (ox if dx else 1.0 - ox) * (oy if dy else 1.0 - oy) * (oz if dz else 1.0 - oz)
        lane0 = (blk // bpr) * 128 + (blk % bpr) * (8 * f) + parity * f
        part = w_c[:, None] * _bf16(flat[lane0[:, None] + feat])
        acc = part if acc is None else acc + part
    return acc


def _block_exact_twin(
    pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int, hash_table_size: int
) -> torch.Tensor:
    """Plain PyTorch K3: (n, 3) -> (n, L*F)."""
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


_LIB: Optional[ctypes.CDLL] = None


def _kernel_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from nerfstudio_torch.ops import cuda_build

        lib = cuda_build.load("hash_grid")
        lib.nst_hash_encode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.nst_hash_encode_block.restype = ctypes.c_int
        lib.nst_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nst_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _block_kernel(
    pos: torch.Tensor, table: torch.Tensor, *, min_res: int, max_res: int,
    hash_table_size: int, exact: bool,
) -> torch.Tensor:
    """Launch the CUDA kernel (K3 if ``exact`` else K1 forward)."""
    L, S, _ = table.shape
    F = 128 * S // hash_table_size
    n = pos.shape[0]
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    lib = _kernel_library()
    res = compute_level_resolutions(L, min_res, max_res)
    res_arr = (ctypes.c_int * L)(*[int(r) for r in res])
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = lib.nst_hash_encode_block(
            pos.data_ptr(), table.data_ptr(), out.data_ptr(), n, L, F, S,
            hash_table_size, res_arr, int(exact), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"hash-grid kernel launch failed: {lib.nst_cuda_error_string(err).decode()}"
        )
    launch_counts["hash_encode_block_exact" if exact else "hash_encode_block"] += 1
    return out


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
    if not (positions.is_contiguous() and table.is_contiguous()):
        raise ValueError("hash_encode takes contiguous positions and table")
    S = table.shape[1]
    if hash_table_size % 8 or (128 * S) % hash_table_size:
        raise ValueError(f"table rows {S} do not match hash_table_size {hash_table_size}")
    F = 128 * S // hash_table_size
    if F not in (1, 2, 4, 8, 16):
        raise ValueError(f"features_per_level {F} must be 1, 2, 4, 8 or 16 for the block layout")
    if torch.is_grad_enabled() and (positions.requires_grad or table.requires_grad):
        raise NotImplementedError("hash_encode is forward only: run it under torch.no_grad()")


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
) -> torch.Tensor:
    """Encode positions in [0,1]^3 (reference :755-1044).

    positions: (..., 3) float32; table: (num_levels, S, 128) float32 with
    S = hash_table_size * F / 128. Returns (..., num_levels * F) float32,
    column order l*F + f. ``block_exact`` takes K3, ``block`` alone takes K1.
    CUDA tensors launch the kernel, CPU tensors run the twin; any other
    device raises."""
    if not (block or block_exact):
        raise NotImplementedError("the flat hash-grid layout (K7) is not ported")
    _check_inputs(positions, table, num_levels, hash_table_size)
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    kw = dict(min_res=min_res, max_res=max_res, hash_table_size=hash_table_size)
    if pos.device.type == "cuda":
        out = _block_kernel(pos, table, exact=block_exact, **kw)
    elif pos.device.type == "cpu":
        twin = _block_exact_twin if block_exact else _block_stochastic_twin
        out = twin(pos, table, **kw)
    else:
        raise ValueError(f"hash_encode runs on cuda or cpu tensors, got {pos.device}")
    return out.reshape(batch_shape + (out.shape[-1],))


def init_hash_table(
    num_levels: int, hash_table_size: int, features_per_level: int, scale: float = 1e-4, device=None
) -> torch.Tensor:
    """Uniform(-scale, scale) table in the (L, S, 128) layout (reference :1047-1071)."""
    if 128 % features_per_level or hash_table_size % (128 // features_per_level):
        raise ValueError(
            f"features_per_level {features_per_level} must divide 128 and 128/F must divide "
            f"hash_table_size {hash_table_size}"
        )
    table = torch.empty(
        (num_levels, hash_table_size * features_per_level // 128, 128), dtype=torch.float32, device=device
    )
    return table.uniform_(-scale, scale)
