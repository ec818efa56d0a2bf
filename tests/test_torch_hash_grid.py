"""Parity of the port's block hash-grid encode (K1 forward, K3) with the JAX
reference, through the plain PyTorch twins that CPU tensors take. The CUDA
kernels are held against the same twins on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NO_HASH_LAUNCHES, cuda_device  # noqa: F401  (cuda_device: a fixture)
from nerfstudio_tpu.ops import hash_grid as jhg
from nerfstudio_torch.ops import hash_grid as thg

# (L, T, F, min_res, max_res): each case has dense and hashed levels
# (dense while ((res+2)//2)^3 * 8 <= T); in the last, level 1 (res 14,
# 8^3 blocks) sits exactly on the threshold.
CASES = [(4, 2**12, 2, 4, 64), (4, 2**10, 4, 2, 48), (3, 2**11, 8, 3, 40), (3, 2**12, 2, 7, 28)]


def _positions(n, seed):
    """Uniform positions plus the boundary hazards: exact 0 and 1, outside
    the cube (-0.1, 1.1), and exactly odd and even cells at several
    resolutions."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    edge = np.array([0.0, 1.0, -0.1, 1.1, 0.5, 0.25, 3 / 64, 5 / 64, 0.999999], np.float32)
    corners = np.stack(np.meshgrid(edge, edge[:3], edge[::2], indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([pos, corners]).astype(np.float32)


def _table(L, T, F, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (L, T * F // 128, 128)).astype(np.float32)


@pytest.mark.parametrize("L,T,F,min_res,max_res", CASES)
def test_block_level_geometry_matches_jax_exactly(L, T, F, min_res, max_res):
    """Stochastic rounding hazard: rows and slot must be EXACTLY equal (a
    single flipped coin moves a sample to another block); w8 within 1e-7
    (the weights are products of the same float32 factors)."""
    pos = _positions(2000, 0)
    pos = np.clip(pos, 0.0, 1.0)  # the field clips via its selector; geometry takes [0, 1]
    kw = dict(num_levels=L, min_res=min_res, max_res=max_res, hash_table_size=T, features_per_level=F)
    jg = jhg.block_level_geometry(jnp.asarray(pos), **kw)
    tg = thg.block_level_geometry(torch.from_numpy(pos), **kw)
    for (jr, js, jw), (tr, ts, tw) in zip(jg, tg):
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=0, atol=1e-7)


def test_u01_hash_is_bit_exact():
    """The odd-axis coin hashes float bits with uint32 wrap-around: the
    int64 twin must give the same variate for every bit pattern."""
    rng = np.random.default_rng(1)
    o = np.concatenate(
        [rng.uniform(0, 1, 5000), [0.0, 1.0, 0.5, np.nextafter(np.float32(1), 0), 1e-30]]
    ).astype(np.float32)
    for p1, p2 in thg._COIN_PRIMES:
        ref = np.asarray(jhg._u01_hash(jnp.asarray(o), p1, p2))
        np.testing.assert_array_equal(ref, thg._u01_hash(torch.from_numpy(o), p1, p2).numpy())


def test_hash_corner_matches_uint32_reference():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2**20, (3, 5000)).astype(np.int32)
    for size in (2**7, 2**14, 2**16 + 8):
        ref = np.asarray(jhg._hash_corner(*(jnp.asarray(x) for x in c), size))
        got = thg._hash_corner(*(torch.from_numpy(x) for x in c), size)
        np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("L,T,F,min_res,max_res", CASES)
def test_dense_or_hashed_layout_per_level(L, T, F, min_res, max_res):
    """Per-level layout hazard: dense iff ((res+2)//2)^3 * 8 <= T, and every
    case here mixes both kinds."""
    kinds = []
    for res in jhg.compute_level_resolutions(L, min_res, max_res):
        bs, dense = thg._block_level_layout(int(res), T)
        assert bs == (int(res) + 2) // 2
        assert dense == (bs**3 * 8 <= T)
        kinds.append(dense)
    assert any(kinds) and not all(kinds)


@pytest.mark.parametrize("exact", [False, True], ids=["K1_block", "K3_block_exact"])
@pytest.mark.parametrize("L,T,F,min_res,max_res", CASES)
def test_twin_matches_jax_hash_encode(L, T, F, min_res, max_res, exact):
    """Twin vs JAX hash_encode(block=True / block_exact=True) within 1e-6
    with tables in +-1: both read bf16-rounded values and sum in float32;
    only the summation order differs."""
    pos = _positions(3000, 3)
    table = _table(L, T, F, 4)
    kw = dict(num_levels=L, min_res=min_res, max_res=max_res, hash_table_size=T)
    flag = dict(block_exact=True) if exact else dict(block=True)
    ref = np.asarray(jhg.hash_encode(jnp.asarray(pos), jnp.asarray(table), **kw, **flag))
    got = thg.hash_encode(torch.from_numpy(pos), torch.from_numpy(table), **kw, **flag)
    assert got.shape == ref.shape == (pos.shape[0], L * F)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_table_reads_round_to_bf16_nearest_even():
    """bf16 hazard: values exactly halfway between two bf16 numbers must
    round to the even one, as jnp.astype(bfloat16) does, before weighting."""
    L, T, F = 1, 2**10, 4
    table = np.zeros((L, T * F // 128, 128), np.float32)
    halfway = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1 + 2**-9], np.float32)
    table[...] = np.resize(halfway, table.shape)
    pos = np.full((1, 3), 0.5, np.float32)
    kw = dict(num_levels=L, min_res=8, max_res=8, hash_table_size=T, block_exact=True)
    ref = np.asarray(jhg.hash_encode(jnp.asarray(pos), jnp.asarray(table), **kw))
    got = thg.hash_encode(torch.from_numpy(pos), torch.from_numpy(table), **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    bf = torch.from_numpy(halfway).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf, [1.0, 1 + 4 * 2**-8, -1.0, 1.0])


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    thg.reset_launch_counts()
    pos = torch.from_numpy(_positions(100, 5))
    table = torch.from_numpy(_table(2, 2**10, 4, 6))
    kw = dict(num_levels=2, min_res=4, max_res=16, hash_table_size=2**10)
    out_k1 = thg.hash_encode(pos, table, block=True, **kw)
    out_k3 = thg.hash_encode(pos, table, block_exact=True, **kw)
    assert thg.launch_counts == NO_HASH_LAUNCHES
    torch.testing.assert_close(out_k1, thg._block_stochastic_twin(pos, table, min_res=4, max_res=16, hash_table_size=2**10), rtol=0, atol=0)
    torch.testing.assert_close(out_k3, thg._block_exact_twin(pos, table, min_res=4, max_res=16, hash_table_size=2**10), rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    pos = torch.rand(8, 3)
    table = torch.rand(2, 32, 128)
    kw = dict(num_levels=2, min_res=4, max_res=16, hash_table_size=2**10)
    assert thg.hash_encode(pos, table, **kw).shape == (8, 2 * 4)  # the flat layout (K7) is ported
    with pytest.raises(TypeError):
        thg.hash_encode(pos.double(), table, block=True, **kw)
    with pytest.raises(ValueError):
        thg.hash_encode(pos, table[:1], block=True, **kw)
    with pytest.raises(ValueError):
        thg.hash_encode(pos.t().contiguous().t(), table, block=True, **kw)
    with pytest.raises(ValueError):
        thg.hash_encode(pos.to("meta"), table.to("meta"), block=True, **kw)
    with pytest.raises(NotImplementedError):
        thg.hash_encode(pos, table.requires_grad_(), block_exact=True, **kw)  # K3 is forward only


# The shipped divisors (levels L5 and L8; T/8 at T = 2^17 and 2^19, and at
# this file's Ts) and others that take the multiply: small odd ones, T/8 of
# non-power-of-two tables, and the uint32 extremes.
U32_DIVISORS = [1, 2, 5, 8, 2**14, 2**16, 128, 256, 512, 3, 6, 7, 384, 8193, 65_537, 2**31 - 1, 2**31,
                2**31 + 1, 2**32 - 1]


@pytest.mark.parametrize("d", U32_DIVISORS)
def test_u32_divisor_divides_every_uint32(d):
    """The lane kernels' 32-bit divide, step for step in numpy: a mask and
    a shift for a power of two, else t = umulhi(x, magic), q = (t + ((x -
    t) >> 1)) >> (shift - 1); equal to x // d and x % d at 0, 1, 2^31 - 1,
    2^31, 2^32 - 1, the multiples of d and their neighbours, and random
    uint32 values (the hash of a block coordinate spans all of them)."""
    magic, shift = thg._u32_divisor(d)
    assert 0 <= magic < 2**32 and 0 <= shift <= 32
    assert (magic == 0) == (d & (d - 1) == 0)
    rng = np.random.default_rng(d % 2**32)
    mult = np.arange(0, 2**32 // d + 1, max(1, 2**32 // d // 500), dtype=np.uint64) * np.uint64(d)
    x = np.concatenate([np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64),
                        mult, mult + np.uint64(1), mult[1:] - np.uint64(1),
                        rng.integers(0, 2**32, 20_000, dtype=np.uint64)])
    x = x[x < 2**32]
    if magic == 0:
        q, r = x >> np.uint64(shift), x & np.uint64(d - 1)
    else:
        t = (x * np.uint64(magic)) >> np.uint64(32)
        q = (t + ((x - t) >> np.uint64(1))) >> np.uint64(shift - 1)
        r = x - q * np.uint64(d)
    np.testing.assert_array_equal(q, x // np.uint64(d))
    np.testing.assert_array_equal(r, x % np.uint64(d))


def test_block_design_defaults_and_checks():
    """F = 2 and 4 (every shipped config) take the lane-group design by
    default, the other widths the per-thread kernel; a lane design at
    another width, or an unknown name, raises. K1's forward, K3 and both
    backwards (K1 bwd, K7 bwd) pick from the same designs, with the C design
    codes 0 (per-thread) and 1 (lane groups); K7's private pass is no design
    of its own but follows the input (``test_k7_launch_plan_by_design``)."""
    assert thg.DESIGNS == {"per-thread": 0, "lane-groups": 1}
    for f in (2, 4):
        assert thg._pick_design(f) == thg._DEFAULT == "lane-groups"
    for f in (1, 8, 16):
        assert thg._pick_design(f) == "per-thread"
    for d in thg.DESIGNS:
        assert thg._pick_design(4, d) == d
    with pytest.raises(ValueError):
        thg._pick_design(8, "lane-groups")
    for name in ("no such design", "privatised"):
        with pytest.raises(ValueError):
            thg._pick_design(4, name)


# (L, T, F, min_res, max_res) of the card test: both lane widths, dense and
# hashed levels, level counts and T/8 that are powers of two and not.
CARD_CASES = [(4, 2**12, 2, 4, 64), (5, 3 * 2**10, 4, 4, 64), (8, 2**13, 4, 16, 512), (5, 3 * 2**11, 2, 7, 28)]


@pytest.mark.parametrize("exact", [False, True], ids=["K1_block", "K3_block_exact"])
@pytest.mark.parametrize("L,T,F,min_res,max_res", CARD_CASES)
def test_block_encode_kernels_match_the_twin_on_the_card(cuda_device, L, T, F, min_res, max_res, exact):
    """Every design of K1's forward and K3 against the twin on the card,
    within 1e-5 abs and no sample off by 1e-3 (the same geometry bits; only
    the order of the 8-term sum differs), on a sample count that leaves a
    ragged last block of threads."""
    pos = torch.from_numpy(_positions(3001, 7)).to(cuda_device)
    table = torch.from_numpy(_table(L, T, F, 8)).to(cuda_device)
    kw = dict(min_res=min_res, max_res=max_res, hash_table_size=T)
    twin = thg._block_exact_twin if exact else thg._block_stochastic_twin
    want = twin(pos, table, **kw)
    for design in thg.DESIGNS:
        got = thg._block_kernel(pos, table, exact=exact, _design=design, **kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        assert torch.isfinite(got).all(), design
        assert float(diff.max()) <= 1e-5, design
        assert int((diff.amax(dim=-1) > 1e-3).sum()) == 0, design
