"""The gather probes in the port against the Pallas probes of ``exp/``.

``kernel`` (``exp/pallas_gather.py:20``), ``g1_kernel`` and ``g2_kernel``
(``exp/pallas_gather2.py:35, :83``) are module-level: they run here through
``pl.pallas_call(..., interpret=True)`` with the probes' own BlockSpecs, at
two grid steps along the index blocks and shrunken table and block sizes
(the kernels read S, F and BLK from their module, patched for the call).
Two steps, because the probes' output index maps give element offsets
(``b * BLK``) where Pallas takes block indices: block 0 is right, and
interpret mode clamps block BLK to the last block, which at two steps is
block 1, the intended one. ``run_case``'s and ``f4``'s kernels are nested
in their benchmark functions; they are held against the checks those
scripts make (``exp/pallas_gather3.py:52-55``; ``take_along_axis(tab, rows
% S, 0)``).

Every probe moves or multiplies values in float32 in the probe's order, so
the comparisons are exact."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_port import cuda_device, to_torch  # noqa: F401  (cuda_device: a fixture)
from nerfstudio_torch.ops import gather_probes as gp

EXP = Path(__file__).resolve().parents[1] / "exp"
VMEM = dict(memory_space=pltpu.VMEM)
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _probe(name):
    spec = importlib.util.spec_from_file_location(f"probe_{name}", EXP / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(rows, dtype, seed=0):
    """(numpy table for JAX, torch table): normal values, in bf16 rounded
    identically on both sides."""
    t = np.random.default_rng(seed).normal(size=(rows, 128)).astype(np.float32)
    jt = jnp.asarray(t).astype(DTYPES[dtype][0])
    return jt, to_torch(np.asarray(jt.astype(jnp.float32))).to(DTYPES[dtype][1])


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


# (dtype, F): the probes' F = 4 keeps its dtype-only id; F = 2 and 8 are
# served by the kernels' general path, and the Pallas kernels read F from
# their module at trace time, patched for the call.
DTYPE_F = [pytest.param(d, f, id=d if f == 4 else f"{d}-F{f}") for f in (4, 2, 8) for d in DTYPES]


@pytest.mark.parametrize("dtype,f", DTYPE_F)
def test_fused_gather_matches_pallas(dtype, f, monkeypatch):
    mod = _probe("pallas_gather")
    s, nb = 512, 2
    monkeypatch.setattr(mod, "S", s)
    monkeypatch.setattr(mod, "F", f)
    rng = np.random.default_rng(1)
    jt, tt = _table(s, dtype)
    rows = rng.integers(0, s, (8, nb, s)).astype(np.int32)
    slots = rng.integers(0, 128 // mod.F, (8, nb, s)).astype(np.int32)
    w = rng.uniform(size=(8, nb, s)).astype(np.float32)
    want = pl.pallas_call(
        mod.kernel,
        grid=(nb, 8),
        in_specs=[pl.BlockSpec((s, 128), lambda b, c: (0, 0), **VMEM)]
        + [pl.BlockSpec((1, 1, s), lambda b, c: (c, b, 0), **VMEM)] * 3,
        out_specs=pl.BlockSpec((1, s, 128), lambda b, c: (b, 0, 0), **VMEM),
        out_shape=jax.ShapeDtypeStruct((nb, s, 128), jnp.float32),
        interpret=True,
    )(jt, rows, slots, w)
    got = gp.fused_gather(tt, to_torch(rows), to_torch(slots), to_torch(w), features=f)
    assert got.shape == (nb, s, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stage1_matches_pallas(dtype, monkeypatch):
    mod = _probe("pallas_gather2")
    s, blk, nb = 1024, 256, 2
    monkeypatch.setattr(mod, "BLK", blk)
    jt, tt = _table(s, dtype, seed=2)
    rows = np.random.default_rng(3).integers(0, s, (nb, blk)).astype(np.int32)
    want = pl.pallas_call(
        mod.g1_kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec((s, 128), lambda b: (0, 0), **VMEM), pl.BlockSpec((1, blk), lambda b: (b, 0), **VMEM)],
        out_specs=pl.BlockSpec((blk, 128), lambda b: (b * blk, 0), **VMEM),
        out_shape=jax.ShapeDtypeStruct((nb * blk, 128), jt.dtype),
        interpret=True,
    )(jt, rows)
    got = gp.stage1(tt, to_torch(rows))
    assert got.shape == (nb * blk, 128) and got.dtype == tt.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype,f", DTYPE_F)
def test_stage2_matches_pallas(dtype, f, monkeypatch):
    mod = _probe("pallas_gather2")
    s, blk, nb = 1024, 256, 2
    monkeypatch.setattr(mod, "BLK", blk)
    monkeypatch.setattr(mod, "F", f)
    rng = np.random.default_rng(4)
    jt, tt = _table(s, dtype, seed=5)
    rows = rng.integers(0, s, (nb, 8, blk)).astype(np.int32)
    slots = rng.integers(0, 128 // mod.F, (nb, 8, blk)).astype(np.int32)
    slots[:, :4, :8] = 3  # corners sharing a slot: the sum runs over them in order
    w = rng.uniform(size=(nb, 8, blk)).astype(np.float32)
    want = pl.pallas_call(
        mod.g2_kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec((s, 128), lambda b: (0, 0), **VMEM)]
        + [pl.BlockSpec((1, 8, blk), lambda b: (b, 0, 0), **VMEM)] * 3,
        out_specs=pl.BlockSpec((blk, 128), lambda b: (b * blk, 0), **VMEM),
        out_shape=jax.ShapeDtypeStruct((nb * blk, 128), jnp.float32),
        interpret=True,
    )(jt, rows, slots, w)
    got = gp.stage2(tt, to_torch(rows), to_torch(slots), to_torch(w), features=f)
    assert got.shape == (nb * blk, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("table_rows", gp.RUN_CASE_TABLES)
def test_run_case_matches_its_check(table_rows):
    """out[i, j] == table[rows[i, j], j] (pallas_gather3.py's own check), at
    both of the script's table sizes."""
    rng = np.random.default_rng(6)
    tab = rng.normal(size=(table_rows, 128)).astype(np.float32)
    rows = rng.integers(0, table_rows, (512, 128)).astype(np.int32)
    got = gp.run_case(to_torch(tab), to_torch(rows)).numpy()
    np.testing.assert_array_equal(got, tab[rows, np.arange(128)[None, :]])


def test_f4_matches_take_along_axis():
    """``take_along_axis(tab, rows % S, axis=0)`` with Python's modulo:
    rows past the table and negative rows wrap as ``jnp``'s ``%`` does."""
    rng = np.random.default_rng(7)
    s = 96
    tab = rng.normal(size=(s, 128)).astype(np.float32)
    rows = rng.integers(-3 * s, 3 * s, (300, 128)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(rows) % s, axis=0))
    got = gp.f4(to_torch(tab), to_torch(rows)).numpy()
    np.testing.assert_array_equal(got, want)


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


@pytest.mark.parametrize("s", [96, gp.F4_TABLE_ROWS])
def test_f4_wraps_every_int32(s):
    """f4's modulo at the int32 extremes and around the table's edges
    (INT32_MIN, INT32_MAX, -1, -S, S and their neighbours), and over the
    whole int32 range: the values the kernels' 32-bit modulo must get right,
    against ``jnp``'s ``%``."""
    rng = np.random.default_rng(8)
    tab = rng.normal(size=(s, 128)).astype(np.float32)
    edges = [INT32_MIN, INT32_MIN + 1, INT32_MAX, INT32_MAX - 1, -1, 0, 1, -s, -s - 1, -s + 1, s, s - 1, s + 1]
    rows = rng.integers(INT32_MIN, INT32_MAX, (64, 128), dtype=np.int64, endpoint=True).astype(np.int32)
    rows[: len(edges)] = np.asarray(edges, np.int32)[:, None]
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(rows) % s, axis=0))
    np.testing.assert_array_equal(gp.f4(to_torch(tab), to_torch(rows)).numpy(), want)


@pytest.mark.parametrize("table_rows,dtype,fit", [
    (gp.F4_TABLE_ROWS, torch.float32, 8),     # f4: 8 columns of 16 KB, 32 B of a row
    (gp.RUN_CASE_TABLES[0], torch.float32, 2),  # run_case, 16384 rows: 2 of 64 KB, 8 B
    (gp.RUN_CASE_TABLES[1], torch.float32, 64),  # run_case, 512 rows: 64 of 2 KB
    (gp.F4_TABLE_ROWS, torch.bfloat16, 16),
    (gp.RUN_CASE_TABLES[0], torch.bfloat16, 4),
    (gp.RUN_CASE_TABLES[1], torch.bfloat16, 128),  # the whole table
    (58_112, torch.float32, 1),   # one column of 227 KB exactly
    (58_113, torch.float32, 0),   # one column too many
    (116_225, torch.bfloat16, 0),
])
def test_lane_plan(table_rows, dtype, fit):
    """The columns a block of the shared-memory lane gather can hold: a
    power of two dividing 128 whose columns fit a block's 227 KB, the
    largest such (or all 128), 0 exactly where one column does not fit. The
    plan takes them where they fill a 32-byte sector of an output row (f4,
    and run_case's 512-row table), and 0 (the per-element kernel) below
    that (run_case's 16384-row table)."""
    elem = torch.empty((), dtype=dtype).element_size()
    got = gp._columns_that_fit(table_rows, elem)
    assert got == fit
    column = table_rows * elem
    if got:
        assert 128 % got == 0 and got & (got - 1) == 0
        assert got * column <= gp._SMEM_BUDGET
        assert got == 128 or 2 * got * column > gp._SMEM_BUDGET
    else:
        assert column > gp._SMEM_BUDGET
    plan = gp._lane_plan(table_rows, elem)
    assert plan == (fit if fit * elem >= 32 else 0)
    if (table_rows, dtype) == (gp.RUN_CASE_TABLES[0], torch.float32):
        assert plan == 0
    if (table_rows, dtype) in ((gp.F4_TABLE_ROWS, torch.float32), (gp.RUN_CASE_TABLES[1], torch.float32)):
        assert plan > 0


@pytest.mark.parametrize("s", [1, 2, 3, 7, 96, 512, gp.F4_TABLE_ROWS, 4097, 16384, 58_113, 2**30 - 1, 2**30,
                               2**30 + 1, 2**31 - 1])
def test_divisor_magic_gives_pythons_modulo(s):
    """The kernels' 32-bit modulo, step for step in numpy: x = r for r >= 0
    and ~r = -r - 1 below (both in [0, 2^31)), q = umulhi(x, magic) >>
    shift, x - q*s, mirrored below zero; equal to Python's ``r % s`` for the
    int32 extremes, the multiples of s and their neighbours, and random
    int32 values. s = 1 never reaches the multiply (x mod 1 is 0)."""
    magic, shift = gp._divisor_magic(s)
    assert 0 <= magic < 2**32 and 0 <= shift <= 31
    rng = np.random.default_rng(s)
    mult = np.arange(-(2**31) // s, 2**31 // s + 1, max(1, 2**31 // s // 500), dtype=np.int64) * s
    r = np.concatenate([np.asarray([INT32_MIN, INT32_MIN + 1, INT32_MAX, INT32_MAX - 1, -1, 0, 1], np.int64),
                        mult - 1, mult, mult + 1,
                        rng.integers(INT32_MIN, INT32_MAX, 20_000, dtype=np.int64, endpoint=True)])
    r = r[(r >= INT32_MIN) & (r <= INT32_MAX)]
    x = np.where(r >= 0, r, -r - 1).astype(np.uint64)
    if s == 1:
        got = np.zeros_like(r)
    else:
        q = ((x * np.uint64(magic)) >> np.uint64(32)) >> np.uint64(shift)
        rem = (x - q * np.uint64(s)).astype(np.int64)
        got = np.where(r >= 0, rem, s - 1 - rem)
    np.testing.assert_array_equal(got, r % s)


@pytest.mark.parametrize("table_rows,dtype,modulo", [
    (gp.F4_TABLE_ROWS, torch.float32, True),
    (gp.RUN_CASE_TABLES[0], torch.float32, False),
    (gp.RUN_CASE_TABLES[1], torch.float32, False),
    (gp.RUN_CASE_TABLES[1], torch.bfloat16, True),
    (70_000, torch.float32, False),  # no column fits: the per-element path only
])
def test_lane_gather_kernels_match_the_twin_on_the_card(cuda_device, table_rows, dtype, modulo):
    """Both lane-gather kernels (shared-memory columns at the lanes that fit
    and at fewer, one thread per element) equal the twin exactly on the
    card, on a row count that leaves a ragged last tile and rows over the
    whole int32 range (clamped, or taken mod the table's rows)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    tab = torch.randn((table_rows, 128), generator=gen, device=cuda_device).to(dtype)
    rows = torch.randint(INT32_MIN, INT32_MAX, (3001, 128), generator=gen, device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    if not modulo:
        rows[100:] = torch.remainder(rows[100:], table_rows)  # mostly in the table, some clamped
    want = gp._lane_gather_twin(tab.cpu(), rows.cpu(), modulo) if modulo else torch.gather(
        tab.cpu(), 0, rows.cpu().long().clamp(0, table_rows - 1))
    fit = gp._columns_that_fit(table_rows, tab.element_size())
    for lanes in sorted({fit, fit // 2, 0}):
        got = gp._lane_gather("f4" if modulo else "run_case", tab, rows, modulo, lanes=lanes)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), lanes


def test_probe_shapes_are_the_scripts():
    """The module's shapes are the probes' own, read from the scripts."""
    g, g2 = _probe("pallas_gather"), _probe("pallas_gather2")
    assert (gp.S, gp.F, gp.N_BLOCKS, gp.CORNERS) == (g.S, g.F, g.N_BLOCKS, g.CORNERS)
    assert (gp.M, gp.BLK) == (g2.M, g2.BLK)
    assert gp.F4_TABLE_ROWS == 2**19 // 128 and gp.F4_ROWS == 4_000_000 // 128


def test_cpu_takes_the_twins_and_inputs_are_checked():
    gp.reset_launch_counts()
    tab = torch.zeros((8, 128))
    rows = torch.zeros((2, 128), dtype=torch.int32)
    gp.run_case(tab, rows)
    gp.f4(tab, rows)
    gp.stage1(tab, rows[:, :4].contiguous())
    assert all(v == 0 for v in gp.launch_counts.values())
    with pytest.raises(ValueError):
        gp.stage1(torch.zeros((8, 64)), rows)
    with pytest.raises(ValueError):
        gp.run_case(tab, rows[:, :64].contiguous())


def _select_inputs(rng, shape, table_rows, n_slots):
    rows = rng.integers(0, table_rows, shape).astype(np.int32)
    slots = rng.integers(0, n_slots, shape).astype(np.int32)
    w = rng.uniform(size=shape).astype(np.float32)
    return rows, slots, w


@pytest.mark.parametrize("probe", ["fused_gather", "stage2"])
def test_gather_select_checks_shapes_and_alignment(probe):
    """slots and w must have rows' shape (a shorter one would be read past
    its end on the card), on every device; the table must be 16-byte
    aligned for the rows design's vector loads (F = 4)."""
    fn = getattr(gp, probe)
    rng = np.random.default_rng(10)
    shape = (2, 8, 64) if probe == "stage2" else (8, 2, 64)  # 8 corners
    rows, slots, w = (to_torch(x) for x in _select_inputs(rng, shape, 32, 32))
    tab = torch.zeros((32, 128))
    fn(tab, rows, slots, w)
    for bad in ((rows, slots[:, :, :32].contiguous(), w), (rows, slots, w[:1].contiguous()),
                (rows, slots.reshape(shape[0], -1), w)):
        with pytest.raises(ValueError, match="share one 3-d shape"):
            fn(tab, *bad)
    with pytest.raises(ValueError, match="3-d"):
        fn(tab, *(x.reshape(shape[0], -1) for x in (rows, slots, w)))
    shifted = torch.zeros(32 * 128 + 1)[1:].view(32, 128)  # 4 bytes past an aligned allocation
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(shifted, rows, slots, w)
    fn(shifted, rows, slots, w, features=2)  # the per-lane walk takes any alignment
    three = (lambda x: x[:, :3].contiguous()) if probe == "stage2" else (lambda x: x[:3].contiguous())  # noqa: E731
    fn(shifted, three(rows), three(slots), three(w))  # and any corner count but 8
    with pytest.raises(ValueError, match="must divide 128"):
        fn(tab, rows, slots, w, features=3)


def test_gather_select_designs_on_the_cpu():
    """An unknown design raises; on the CPU every design takes the twin and
    launches nothing."""
    rng = np.random.default_rng(11)
    tab = to_torch(rng.normal(size=(64, 128)).astype(np.float32))
    gp.reset_launch_counts()
    for masked, probe, shape in ((False, "fused_gather", (8, 2, 40)), (True, "stage2", (2, 8, 40))):
        rows, slots, w = (to_torch(x) for x in _select_inputs(rng, shape, 64, 32))
        want = getattr(gp, probe)(tab, rows, slots, w).reshape(-1, 128)
        for design in gp.GATHER_SELECT_DESIGNS:
            got = gp._gather_select(probe, tab, rows, slots, w, gp.F, masked, _design=design)
            assert torch.equal(got, want), design
        with pytest.raises(ValueError, match="is not one of"):
            gp._gather_select(probe, tab, rows, slots, w, gp.F, masked, _design="per_lane")
    assert all(v == 0 for v in gp.launch_counts.values())
    assert gp.GATHER_SELECT_DESIGNS[0] == "rows"


def _assert_same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """Equal float32 bits, signed zeros included, and NaN where the other
    has NaN: on the CPU a NaN's payload depends on the operand order that
    vectorised code picks (the card's NaN is canonical)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = lambda x: np.ascontiguousarray(x, np.float32).view(np.int32)[~nan]  # noqa: E731
    np.testing.assert_array_equal(bits(got), bits(want))


def _staged_sums(tab, rows, slots, w):
    """(stage2's rows, fused_gather's rows) as the rows design's staged sums
    compute them (F = 4, 8 corners), in numpy float32, from corner-major (8,
    n) indices; see test_staged_sums_equal_the_twin_bit_for_bit."""
    n, zero = rows.shape[1], np.float32(0.0)
    masked = np.empty((n, 128), np.float32)
    broadcast = np.empty((n, 128), np.float32)
    with np.errstate(invalid="ignore"):  # 0 * inf and inf - inf: NaN, as the probes give
        for k in range(n):
            sel = [int(s) if 0 <= s < 32 else -1 for s in slots[:, k]]
            t = [tab[rows[c, k], 4 * sel[c]:4 * sel[c] + 4] * w[c, k] if sel[c] >= 0 else None for c in range(8)]
            z = [zero * w[c, k] for c in range(8)]
            b = zero
            for c in range(8):
                b = np.float32(b + z[c])
            row = np.full((32, 4), b, np.float32)
            for c in range(8):
                if sel[c] >= 0 and sel[c] not in sel[:c]:
                    acc = np.zeros(4, np.float32)
                    for d in range(8):
                        acc = (acc + (t[d] if sel[d] == sel[c] else np.full(4, z[d], np.float32))).astype(np.float32)
                    row[sel[c]] = acc
            masked[k] = row.reshape(-1)
            acc = None
            for c in range(8):
                e = min(max(int(slots[c, k]), 0), 31)
                term = (tab[rows[c, k], 4 * e:4 * e + 4] * w[c, k]).astype(np.float32)
                acc = term if acc is None else (acc + term).astype(np.float32)
            broadcast[k] = np.tile(acc, 32)
    return masked, broadcast


def test_staged_sums_equal_the_twin_bit_for_bit():
    """The rows design's staged sums (F = 4, 8 corners), step for step in
    numpy float32: for stage2 each sample's background b = 0 + 0*w_0 + ...
    + 0*w_7 fills every output group no corner selects, and each selected
    group's sum runs over all eight corners from zero, (group == slot_c ?
    v_c * w_c : 0 * w_c); for fused_gather the row is one four-value sum
    repeated. Bit-equal to the twin with corners sharing a slot, slots
    outside the row's entries, and NaN, infinite, negative and -0 weights."""
    rng = np.random.default_rng(12)
    n, rows_t = 96, 40
    tab = rng.normal(size=(rows_t, 128)).astype(np.float32)
    rows = rng.integers(0, rows_t, (8, n)).astype(np.int32)
    slots = rng.integers(-2, 35, (8, n)).astype(np.int32)
    slots[:4, :16] = 5  # shared slots
    w = rng.uniform(-1, 1, (8, n)).astype(np.float32)
    special = np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
    pick = rng.integers(0, 30, (8, n))
    w = np.where(pick < special.size, special[np.minimum(pick, special.size - 1)], w).astype(np.float32)
    masked, broadcast = _staged_sums(tab, rows, slots, w)

    args = (to_torch(tab), to_torch(rows), to_torch(slots), to_torch(w))
    _assert_same_bits(masked, gp._gather_select_twin(*args, 4, True).numpy())
    # the twin reads slot*F + l%F, so it takes the clamped slots the kernels take
    clamped = to_torch(np.clip(slots, 0, 31).astype(np.int32))
    _assert_same_bits(broadcast, gp._gather_select_twin(args[0], args[1], clamped, args[3], 4, False).numpy())
    assert np.isnan(masked).any() and (masked == 0).any() and np.isfinite(masked).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 4, 16])
@pytest.mark.parametrize("probe", ["fused_gather", "stage2"])
def test_gather_select_designs_match_on_the_card(cuda_device, probe, f, dtype):
    """Both designs bit-equal to each other on the card (NaN payloads
    included), and to the twin where the indices lie in range: at a block
    that is not a multiple of 32 (stage2's BLK = 1000; fused_gather's n =
    3000), with rows and slots over the whole int32 range, and with NaN,
    infinite and negative weights."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    table_rows = 1024
    shape = (3, 8, 1000) if probe == "stage2" else (8, 3, 1000)
    tab = torch.randn((table_rows, 128), generator=gen, device=cuda_device).to(dtype)
    rows = torch.randint(0, table_rows, shape, generator=gen, device=cuda_device, dtype=torch.int32)
    slots = torch.randint(0, 128 // f, shape, generator=gen, device=cuda_device, dtype=torch.int32)
    w = torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1
    w.view(-1)[::7] = float("nan")
    w.view(-1)[3::11] = float("inf")
    wide = lambda: torch.randint(INT32_MIN, INT32_MAX, shape, generator=gen, device=cuda_device,  # noqa: E731
                                 dtype=torch.int64).to(torch.int32)
    masked = probe == "stage2"

    def run(design, *idx):
        out = gp._gather_select(probe, tab, *idx, w, f, masked, _design=design)
        torch.cuda.synchronize()
        return out

    cm = (lambda x: x.permute(1, 0, 2).reshape(8, -1)) if masked else (lambda x: x.reshape(8, -1))  # noqa: E731
    for idx, in_range in (((rows, slots), True), ((wide(), wide()), False)):
        rows_design, element = (run(d, *idx) for d in gp.GATHER_SELECT_DESIGNS)
        assert torch.equal(rows_design.view(torch.int32), element.view(torch.int32))
        if in_range:
            ref = gp._gather_select_twin(tab, cm(idx[0]), cm(idx[1]), cm(w), f, masked)
            assert bool(((rows_design == ref) | (rows_design.isnan() & ref.isnan())).all())
