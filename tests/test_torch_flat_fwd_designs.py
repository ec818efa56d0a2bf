"""K7's forward (the flat hash grid, neus-facto's proposal nets) in its two
designs on the card: which design each width takes, and the refusals of
the lane groups' 32-bit limits, which raise before anything is launched.
Pure Python on the CPU; the designs' outputs are held against the twin on
the card by ``chip_smoke.py`` phase 20 (bit-equal expected) and by the card
test below, which skips here."""

import numpy as np
import pytest
import torch

from _torch_port import NO_HASH_LAUNCHES, cuda_device  # noqa: F401  (cuda_device: a fixture)
from nerfstudio_torch.ops import hash_grid as thg

PROP = dict(min_res=16, max_res=128, hash_table_size=2**17)  # neus-facto's proposal nets: L5 F2


def _inputs(n, L, T, F, seed):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T * F // 128, 128)).astype(np.float32))
    return pos, table


@pytest.mark.parametrize("F,want", [(1, "per-thread"), (2, "lane-groups"), (4, "lane-groups"), (8, "per-thread"),
                                    (16, "per-thread")])
def test_flat_forward_design_by_width(F, want):
    """F = 2 (the shipped proposal nets) and 4 take the lane groups by
    default, the other widths the per-thread kernel; asking the lane groups
    at another width raises."""
    assert thg._pick_design(F) == want
    if want == "per-thread":
        with pytest.raises(ValueError, match="lane-groups design takes F in"):
            thg._pick_design(F, "lane-groups")


def test_lane_groups_refuse_a_misaligned_table_before_launching():
    """The lane groups read 8- and 16-byte vectors: a table that is not
    16-byte aligned raises ValueError in the wrapper, which takes no other
    design and launches nothing."""
    pos, table = _inputs(64, 5, 2**17, 2, 0)
    misaligned = torch.empty(table.numel() + 4)[1 : table.numel() + 1].view(table.shape)
    misaligned.copy_(table)
    assert misaligned.data_ptr() % 16 != 0
    thg.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        thg._flat_kernel(pos, misaligned, _design="lane-groups", **PROP)
    assert thg.launch_counts == NO_HASH_LAUNCHES


@pytest.mark.parametrize("L", [5, 8])
def test_lane_limits_at_the_int32_boundary(L):
    """n * levels must stay below 2^31 (the lane kernels index in 32 bits)."""
    table = torch.zeros((L, 2, 128))
    thg._check_lane_limits(table, (2**31 - 1) // L)
    with pytest.raises(ValueError, match="2\\^31"):
        thg._check_lane_limits(table, -(-(2**31) // L))


def test_cpu_forward_launches_nothing():
    """On CPU tensors K7's forward runs the twin: no launch is counted, in
    either design's count."""
    pos, table = _inputs(300, 5, 2**12, 2, 1)
    thg.reset_launch_counts()
    out = thg.hash_encode(pos, table, num_levels=5, min_res=4, max_res=64, hash_table_size=2**12)
    assert out.shape == (300, 10) and torch.isfinite(out).all()
    assert thg.launch_counts == NO_HASH_LAUNCHES and "hash_encode_flat_per_thread" in thg.launch_counts


@pytest.mark.parametrize("n,L,T,F,lo,hi", [(3001, 5, 2**17, 2, 16, 128), (5000, 5, 3 * 2**10, 2, 7, 28),
                                           (33, 8, 2**13, 4, 16, 512), (1, 3, 2**11, 4, 4, 32)])
def test_flat_forward_designs_match_the_twin_on_the_card(cuda_device, n, L, T, F, lo, hi):
    """Both designs bit-equal to the twin on the card, on uniform positions
    and on ray-ordered ones (neighbouring samples sharing cells), with a
    ragged last block of samples."""
    pos, table = (x.to(cuda_device) for x in _inputs(n, L, T, F, 2))
    half = n // 2
    t = torch.linspace(0.0, 1.0, half, device=cuda_device)[:, None]
    pos[:half] = (0.2 + 0.6 * t * torch.tensor([1.0, 0.7, 0.4], device=cuda_device)).contiguous()
    kw = dict(min_res=lo, max_res=hi, hash_table_size=T)
    want = thg._flat_twin(pos, table, **kw)
    for design in thg.DESIGNS:
        got = thg._flat_kernel(pos, table, _design=design, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), design
