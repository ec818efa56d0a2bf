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

from _torch_port import to_torch
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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_gather_matches_pallas(dtype, monkeypatch):
    mod = _probe("pallas_gather")
    s, nb = 512, 2
    monkeypatch.setattr(mod, "S", s)
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
    got = gp.fused_gather(tt, to_torch(rows), to_torch(slots), to_torch(w))
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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stage2_matches_pallas(dtype, monkeypatch):
    mod = _probe("pallas_gather2")
    s, blk, nb = 1024, 256, 2
    monkeypatch.setattr(mod, "BLK", blk)
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
    got = gp.stage2(tt, to_torch(rows), to_torch(slots), to_torch(w))
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
