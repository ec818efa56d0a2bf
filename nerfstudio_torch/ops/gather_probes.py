"""The hash-table gather probes (counterparts of the Pallas probes in the
JAX package's ``exp/``), one function per probe, named as there:

* ``fused_gather`` (``exp/pallas_gather.py:40``): per corner c and index
  block b, gather whole rows ``table[rows[c, b]]``, take lanes
  ``slots*F + lane % F`` (the entry's F values repeated over the 128 lanes),
  weight by ``w[c, b]`` and sum the corners in order 0..7:
  (CORNERS, N_BLOCKS, S) indices -> (N_BLOCKS, S, 128) float32;
* ``stage1`` (``exp/pallas_gather2.py:41``): whole-row gather, (nb, BLK)
  rows -> (nb*BLK, 128);
* ``stage2`` (``exp/pallas_gather2.py:96``): row gather, one-hot lane mask
  ``lane // F == slot`` and an 8-corner weighted sum from zero, (nb, 8,
  BLK) indices -> (nb*BLK, 128) float32: K7's forward inner loop for one
  level with the lanes left unreduced;
* ``run_case`` (``exp/pallas_gather3.py:26``): per-lane gather
  ``out[i, j] = table[rows[i, j], j]``, (M, 128) rows;
* ``f4`` (``exp/gather_bench.py:83``): ``take_along_axis(tab, rows % S,
  axis=0)``, (n, 128) rows.

The probes' output index maps in ``pallas_gather2.py`` and
``pallas_gather3.py`` give element offsets (``b * BLK``) where Pallas takes
block indices, which is right for block 0 only; these functions compute
the intended function (block b -> output rows b*BLK ...). Tables are
(rows, 128) float32 or bfloat16; indices int32; weights float32. Indices
must lie in the table (slots in its rows): the twins raise on one that
does not, the kernels clamp it, as XLA's gather does, and never read past
the table.

CUDA tensors launch the kernels of ``csrc/gather_probes.cu``
(``row_gather_kernel``, ``lane_gather_smem_kernel`` or, for a table whose
columns do not fit in shared memory a sector's width at a time,
``lane_gather_kernel``, and ``gather_select_rows_kernel``, one warp per
output row, for ``fused_gather`` and ``stage2``) or raise; CPU tensors run
the plain twins below. The module constants are the probes' own shapes."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

# exp/pallas_gather.py
S, F, N_BLOCKS, CORNERS = 16384, 4, 16, 8
# exp/pallas_gather2.py
M, BLK = 1 << 21, 2048
# exp/pallas_gather3.py (run_case's cases) and exp/gather_bench.py (f4)
RUN_CASE_ROWS, RUN_CASE_TABLES = 1 << 20, (16384, 512)
F4_TABLE_ROWS, F4_ROWS = (2**19) // 128, 4_000_000 // 128

_LANES = 128
# Shared memory one block may take on Hopper (227 KB, opted into above 48 KB).
_SMEM_BUDGET = 232448
# One sector of a global-memory access: the unit of the L2's reads and writes.
_SECTOR_BYTES = 32

# The gather-select's designs (fused_gather, stage2), the default first:
# one warp per output row (gather_select_rows_kernel), and one thread per
# output element (gather_select_kernel), kept for chip_smoke.py's comparison.
GATHER_SELECT_DESIGNS = ("rows", "per_element")
# The rows design sums the probes' shape (F = 4, 8 corners) per sample with
# vector loads of the table; any other shape walks per lane, staging 16
# bytes per (sample, corner) for 32 samples in each of a block's 4 warps.
_ROWS_VECTOR_SHAPE = (4, 8)
_ROWS_MAX_CORNERS = _SMEM_BUDGET // (4 * 32 * 16)
# Its offsets are 32-bit: table_rows * 128 and n below 2^31.
_ROWS_MAX_TABLE_ROWS = (2**31 - 1) // _LANES

# Launches of each probe's kernel, counted where it is launched;
# "lane_gather_smem" counts the run_case and f4 launches that took the
# shared-memory kernel, "gather_select_<design>" the fused_gather and
# stage2 launches that took each design.
launch_counts: Dict[str, int] = dict.fromkeys(
    ("fused_gather", "stage1", "stage2", "run_case", "f4", "lane_gather_smem")
    + tuple(f"gather_select_{d}" for d in GATHER_SELECT_DESIGNS), 0)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# --------------------------------------------------------------------------
# plain twins


def _row_gather_twin(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return table[rows.reshape(-1).long()]


def _lane_gather_twin(table: torch.Tensor, rows: torch.Tensor, modulo: bool) -> torch.Tensor:
    idx = rows.long()
    if modulo:
        idx = torch.remainder(idx, table.shape[0])
    return torch.gather(table, 0, idx)


def _gather_select_twin(table: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, w: torch.Tensor,
                        features: int, masked: bool) -> torch.Tensor:
    """rows, slots, w corner-major (C, n) -> (n, 128) float32, summed in the
    probes' order: ``stage2`` from zero, ``fused_gather`` from corner 0."""
    lane = torch.arange(_LANES, device=table.device)
    acc = torch.zeros((rows.shape[1], _LANES), dtype=torch.float32, device=table.device) if masked else None
    for c in range(rows.shape[0]):
        g = table[rows[c].long()].float()  # (n, 128)
        if masked:
            sel = torch.where((lane // features)[None, :] == slots[c][:, None], g, 0.0)
            acc = acc + sel * w[c][:, None]
        else:
            sel = torch.gather(g, 1, slots[c].long()[:, None] * features + (lane % features)[None, :])
            term = sel * w[c][:, None]
            acc = term if acc is None else acc + term
    return acc


# --------------------------------------------------------------------------
# kernels

_LIB: Optional[ctypes.CDLL] = None


def _columns_that_fit(table_rows: int, elem_bytes: int) -> int:
    """The largest power of two dividing 128 whose table columns
    (``table_rows * elem_bytes`` bytes each) fit in one block's shared
    memory, or 0 when not even one column fits."""
    lanes = _LANES
    while lanes and lanes * table_rows * elem_bytes > _SMEM_BUDGET:
        lanes //= 2
    return lanes


def _lane_plan(table_rows: int, elem_bytes: int) -> int:
    """Lanes per block of the shared-memory lane gather: ``_columns_that_fit``
    where a block's piece of an output row (``lanes * elem_bytes``) fills at
    least one 32-byte sector, else 0 (one thread per element, the table read
    through L2). Below a sector, several SMs write each output sector in
    pieces, which costs more than the shared-memory columns save."""
    lanes = _columns_that_fit(table_rows, elem_bytes)
    return lanes if lanes * elem_bytes >= _SECTOR_BYTES else 0


def _divisor_magic(s: int) -> Tuple[int, int]:
    """(magic, shift) with ``x // s == (x * magic >> 32) >> shift`` for every
    0 <= x < 2^31: l = ceil(log2 s), magic = ceil(2^(31 + l) / s) < 2^32,
    shift = l - 1. The kernels take f4's modulo with it in 32 bits; s = 1
    gives (0, 0), which they never use (x mod 1 is 0)."""
    if not 1 <= s < 2**31:
        raise ValueError(f"divisor {s} outside [1, 2^31)")
    if s == 1:
        return 0, 0
    log2 = (s - 1).bit_length()
    return -(-(1 << (31 + log2)) // s), log2 - 1


def kernel_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from nerfstudio_torch.ops import cuda_build

        lib = cuda_build.load("gather_probes")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nst_probe_row_gather.argtypes = [vp, vp, vp, ll, ll, i, vp]
        lib.nst_probe_row_gather.restype = i
        lib.nst_probe_lane_gather.argtypes = [vp, vp, vp, ll, ll, i, i, i, ctypes.c_uint, i, vp]
        lib.nst_probe_lane_gather.restype = i
        lib.nst_probe_gather_select.argtypes = [vp, ll, i, vp, vp, vp, vp, ll, i, ll, ll, ll, i, i, vp]
        lib.nst_probe_gather_select.restype = i
        lib.nst_probe_gather_select_rows.argtypes = [vp, ll, i, vp, vp, vp, vp, ll, i, ll, ll, ll, i, i, vp]
        lib.nst_probe_gather_select_rows.restype = i
        lib.nst_probe_error_string.argtypes = [i]
        lib.nst_probe_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    lib = kernel_library()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.nst_probe_error_string(err).decode()}")
    launch_counts[name] += 1


def _check(name: str, table: torch.Tensor, *indices: torch.Tensor) -> None:
    if table.ndim != 2 or table.shape[1] != _LANES or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: table must be (rows, 128) float32 or bfloat16, got {table.dtype} "
                         f"{tuple(table.shape)}")
    for x in (table,) + indices:
        if x.device != table.device or not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and on one device")
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {table.device}")


def _check_lane_rows(name: str, rows: torch.Tensor) -> None:
    if rows.ndim != 2 or rows.shape[1] != _LANES:
        raise ValueError(f"{name}: rows must be (m, 128), got {tuple(rows.shape)}")


def _row_gather(name: str, table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Launch the whole-row gather on int32 ``rows``."""
    if rows.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32, got {rows.dtype}")
    out = torch.empty((rows.numel(), _LANES), dtype=table.dtype, device=table.device)
    _launch(name, "nst_probe_row_gather", table.device, table.data_ptr(), rows.data_ptr(), out.data_ptr(),
            rows.numel(), table.shape[0], table.element_size())
    return out


def _lane_gather(name: str, table: torch.Tensor, rows: torch.Tensor, modulo: bool,
                 lanes: Optional[int] = None) -> torch.Tensor:
    """Launch the per-lane gather on int32 ``rows`` (m, 128): rows clamped
    to the table, or with ``modulo`` taken mod its rows. ``lanes`` is the
    table columns each block holds in shared memory, ``_lane_plan``'s by
    default; 0 takes the one-thread-per-element kernel."""
    if rows.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32, got {rows.dtype}")
    t, elem = table.shape[0], table.element_size()
    if lanes is None:
        lanes = _lane_plan(t, elem)
    if lanes and (table.data_ptr() % 16 or rows.data_ptr() % 16):
        raise ValueError(f"{name}: table and rows must be 16-byte aligned")
    magic, shift = _divisor_magic(t)
    out = torch.empty(rows.shape, dtype=table.dtype, device=table.device)
    _launch(name, "nst_probe_lane_gather", table.device, table.data_ptr(), rows.data_ptr(), out.data_ptr(),
            rows.shape[0], t, elem, int(modulo), lanes, magic, shift)
    if lanes:
        launch_counts["lane_gather_smem"] += 1
    return out


def _gather_select(name: str, table: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, w: torch.Tensor,
                   features: int, masked: bool, _design: str = "rows") -> torch.Tensor:
    """The gather-select of ``fused_gather`` (``masked`` False: rows, slots
    and w (corners, blocks, s)) or ``stage2`` (True: (blocks, corners,
    blk)) -> (n, 128) float32. On CUDA tensors it launches the kernel of
    ``_design`` (one of ``GATHER_SELECT_DESIGNS``; only chip_smoke.py's
    comparison sets it); on CPU tensors every design takes the twin."""
    if _design not in GATHER_SELECT_DESIGNS:
        raise ValueError(f"design {_design!r} is not one of {GATHER_SELECT_DESIGNS}")
    _check(name, table, rows, slots, w)
    if rows.ndim != 3 or slots.shape != rows.shape or w.shape != rows.shape:
        raise ValueError(f"{name}: rows, slots and w must share one 3-d shape, got {tuple(rows.shape)}, "
                         f"{tuple(slots.shape)} and {tuple(w.shape)}")
    if rows.dtype != torch.int32 or slots.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"{name}: rows and slots must be int32 and w float32")
    if features < 1 or _LANES % features:
        raise ValueError(f"{name}: features {features} must divide 128")
    if masked:
        nb, c, blk = rows.shape
        n, block, block_stride, corner_stride = nb * blk, blk, c * blk, blk
    else:
        c, nb, s = rows.shape
        n = nb * s
        block, block_stride, corner_stride = n, 0, n
    if _design == "rows" and (features, c) == _ROWS_VECTOR_SHAPE and table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned (the rows design reads its entries as "
                         "vectors at F = 4 and 8 corners)")
    if table.device.type == "cpu":
        cm = (lambda x: x.permute(1, 0, 2).reshape(c, n)) if masked else (lambda x: x.reshape(c, n))  # noqa: E731
        return _gather_select_twin(table, cm(rows), cm(slots), cm(w), features, masked)
    out = torch.empty((n, _LANES), dtype=torch.float32, device=table.device)
    args = (table.data_ptr(), table.shape[0], table.element_size(), rows.data_ptr(), slots.data_ptr(), w.data_ptr(),
            out.data_ptr(), n, features, block, block_stride, corner_stride, c, int(masked))
    if _design == "rows":
        if c > _ROWS_MAX_CORNERS or table.shape[0] > _ROWS_MAX_TABLE_ROWS or rows.numel() >= 2**31:
            raise ValueError(f"{name}: the rows design takes at most {_ROWS_MAX_CORNERS} corners, "
                             f"{_ROWS_MAX_TABLE_ROWS} table rows and 2^31 - 1 indices, got {c}, {table.shape[0]}, "
                             f"{rows.numel()}")
        _launch(name, "nst_probe_gather_select_rows", table.device, *args)
    else:
        _launch(name, "nst_probe_gather_select", table.device, *args)
    launch_counts[f"gather_select_{_design}"] += 1
    return out


# --------------------------------------------------------------------------
# the probes


def fused_gather(table: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, w: torch.Tensor,
                 features: int = F) -> torch.Tensor:
    """(rows, 128) table; rows, slots, w (corners, blocks, s) -> (blocks, s,
    128) float32."""
    out = _gather_select("fused_gather", table, rows, slots, w, features, False)
    return out.view(rows.shape[1], rows.shape[2], _LANES)


def stage1(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(rows, 128) table; (nb, blk) rows -> (nb*blk, 128) whole rows."""
    _check("stage1", table, rows)
    if table.device.type == "cpu":
        return _row_gather_twin(table, rows)
    return _row_gather("stage1", table, rows)


def stage2(table: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, w: torch.Tensor,
           features: int = F) -> torch.Tensor:
    """(rows, 128) table; rows, slots, w (nb, corners, blk) -> (nb*blk, 128)
    float32."""
    return _gather_select("stage2", table, rows, slots, w, features, True)


def run_case(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(T, 128) table; (m, 128) rows in [0, T) -> out[i, j] = table[rows[i, j], j]."""
    _check("run_case", table, rows)
    _check_lane_rows("run_case", rows)
    if table.device.type == "cpu":
        return _lane_gather_twin(table, rows, modulo=False)
    return _lane_gather("run_case", table, rows, modulo=False)


def f4(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(S, 128) table; (n, 128) rows -> out[i, j] = tab[rows[i, j] mod S, j]."""
    _check("f4", tab, rows)
    _check_lane_rows("f4", rows)
    if tab.device.type == "cpu":
        return _lane_gather_twin(tab, rows, modulo=True)
    return _lane_gather("f4", tab, rows, modulo=True)
