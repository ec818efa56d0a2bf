"""The plan of K7's private pass (``hash_grid.bwd_plan``): which dense
coarse levels the lane-group backward reduces in one block's shared memory
when it is asked for the table gradient alone, and how many bytes that
block takes, at the three shipped hash-grid configs. The CUDA entry refuses
any other plan; these pin the host's side of it. K1's backward (the
nerfacto configs' block layout) has no private pass: its launches carry an
empty plan in every design."""

import pytest
import torch

from nerfstudio_torch.ops import hash_grid as thg

SHIPPED = {
    # name: (L, log2 T, F, min_res, max_res)
    "neus-facto proposal": (5, 17, 2, 16, 128),
    "nerfacto field": (8, 19, 4, 16, 2048),
    "nerfacto proposal": (5, 17, 2, 16, 256),
}


def _resolutions(name):
    L, log2_t, F, lo, hi = SHIPPED[name]
    return thg.compute_level_resolutions(L, lo, hi), 2**log2_t, F


def test_plan_at_the_neus_facto_proposal_nets():
    """neus-facto's proposal nets (K7, flat, F=2): levels 0-1 are dense and
    small (17^3 and 27^3 entries of 2 floats, 38 and 154 KB) and fit one
    block together; level 2 is dense but 760 KB and is left out; levels 3-4
    are hashed."""
    res, T, F = _resolutions("neus-facto proposal")
    got = thg.bwd_plan(res, T, F)
    assert got == ((0, 1), 4 * (9828 + 39368))
    assert got[1] <= thg.SHARED_BYTES_PER_BLOCK == 227 * 1024  # the H100's per-block limit
    assert sum(4 * thg._private_floats(int(res[l]), T, F) for l in got[0]) == got[1]
    assert 4 * thg._private_floats(int(res[2]), T, F) > thg.SHARED_BYTES_PER_BLOCK  # 45^3 * 2 floats
    assert [thg._private_floats(int(r), T, F) for r in res[3:]] == [None, None]


def test_plan_leaves_out_what_does_not_fit(monkeypatch):
    """The plan fits the block's shared memory: levels 0 and 1 do not fit
    100 KB together, so only level 0 is privatised; nothing fits 1000
    bytes."""
    res, T, F = _resolutions("neus-facto proposal")
    monkeypatch.setattr(thg, "SHARED_BYTES_PER_BLOCK", 100_000)
    assert thg.bwd_plan(res, T, F) == ((0,), 4 * 9828)
    monkeypatch.setattr(thg, "SHARED_BYTES_PER_BLOCK", 1000)
    assert thg.bwd_plan(res, T, F) == ((), 0)


@pytest.mark.parametrize("name", ["nerfacto field", "nerfacto proposal"])
def test_k1_launches_carry_no_plan(name):
    """K1 (the nerfacto configs) has no private pass: every design's launch
    hands the CUDA entry an empty plan."""
    L, log2_t, F, lo, hi = SHIPPED[name]
    table = torch.zeros((L, 2**log2_t * F // 128, 128))
    kw = dict(min_res=lo, max_res=hi, hash_table_size=2**log2_t)
    for design, code in thg.DESIGNS.items():
        assert thg._bwd_launch_plan(design, table, torch.zeros_like(table), 1000, **kw) == (code, 0, 0)


def test_private_copy_sizes():
    """A copy is (res+1)^3 entries of F floats rounded up to 16 bytes;
    hashed levels have none."""
    assert thg._private_floats(16, 2**17, 2) == 9828  # 17^3 * 2 = 9826
    assert thg._private_floats(26, 2**17, 2) == 39368  # 27^3 * 2 = 39366
    assert thg._private_floats(76, 2**17, 2) is None  # 77^3 > 2^17
    assert thg._private_floats(16, 2**19, 4) == 17**3 * 4


PLANNED = (1, 0b11, 4 * (9828 + 39368))


@pytest.mark.parametrize("design,privatise,want", [("per-thread", False, (0, 0, 0)), ("per-thread", True, (0, 0, 0)),
                                                   ("lane-groups", False, (1, 0, 0)),
                                                   ("lane-groups", True, PLANNED)])
def test_k7_launch_plan_by_design(design, privatise, want):
    """The arguments a K7 backward launch hands the CUDA entry at the
    neus-facto proposal shape: design code, private level mask, bytes. Only
    the lane groups asked for the table gradient alone (``privatise``, as
    ``_flat_bwd_kernel`` sets it) carry the plan."""
    table = torch.zeros((5, 2**17 * 2 // 128, 128))
    kw = dict(min_res=16, max_res=128, hash_table_size=2**17)
    got = thg._bwd_launch_plan(design, table, torch.zeros_like(table), 1000, privatise=privatise, **kw)
    assert got == want
