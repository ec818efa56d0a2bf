"""K3b (K3's position gradient) and K1bb (K1's backward differentiated
again), the normals' two hash-grid derivative kernels, in their two designs
on the card: which design each width takes, and the refusals of the lane
groups, which raise before anything is launched. Pure Python on the CPU
(the C entry is replaced by a recorder where a launch is reached); the
designs' outputs are held against the float64 twins on the card by
``chip_smoke.py`` phase 67 and by the card test below, which skips here."""

import numpy as np
import pytest
import torch

from _torch_port import NO_HASH_LAUNCHES, cuda_device  # noqa: F401  (cuda_device: a fixture)
from nerfstudio_torch.ops import hash_grid as thg

KERNELS = ("K3b", "K1bb")


def _inputs(n, L, T, F, seed, device="cpu"):
    """Positions in [-0.1, 1.1]^3, a table in +-1, the encoding's cotangent
    g and the position gradient's cotangent u, from numpy."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-0.1, 1.1, (n, 3)), rng.uniform(-1, 1, (L, T * F // 128, 128)),
              rng.standard_normal((n, L * F)), rng.standard_normal((n, 3)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


def _call(kernel, pos, table, g, u, kw, **design):
    """The kernel's launcher on these inputs: K3b's position gradient, or
    K1bb's three outputs at scales (2, 0, 2, ...)."""
    if kernel == "K3b":
        return thg._block_exact_bwd_kernel(pos, table, g, **design, **kw)
    scales = [2.0 * (1 - l % 2) for l in range(table.shape[0])]
    return thg._block_bwd_bwd_kernel(pos, table, g, u, scales, **design, **kw)


@pytest.fixture
def recorded(monkeypatch):
    """Replace the C entry by a recorder: [(launch count name, C function,
    arguments)], counted as a launch is."""
    calls = []

    def launch(name, fn, pos, *args):
        calls.append((name, fn, args))
        thg.launch_counts[name] += 1

    monkeypatch.setattr(thg, "_launch", launch)
    thg.reset_launch_counts()
    return calls


# the position of the design code among each C entry's arguments (after
# the pointers, the geometry and, for K1bb, the scales)
DESIGN_ARG = {"K3b": 4 + 6, "K1bb": 7 + 6 + 1}


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("F,want", [(1, "per-thread"), (2, "lane-groups"), (4, "lane-groups"), (8, "per-thread"),
                                    (16, "per-thread")])
def test_normals_design_by_width(recorded, kernel, F, want):
    """F = 2 and 4 (every shipped config) launch the lane groups by default,
    the other widths the per-thread kernel, which is also counted under
    ``hash_encode_normals_per_thread``; the launch hands the C entry the
    design's code and the divisor of T/8."""
    L, T = 3, 2**10
    pos, table, g, u = _inputs(64, L, T, F, 0)
    _call(kernel, pos, table, g, u, dict(min_res=4, max_res=32, hash_table_size=T))
    (name, _, args), = recorded
    assert name == {"K3b": "hash_encode_block_exact_bwd", "K1bb": "hash_encode_block_bwd_bwd"}[kernel]
    assert args[DESIGN_ARG[kernel]] == thg.DESIGNS[want]
    assert tuple(args[DESIGN_ARG[kernel] + 1:]) == thg._u32_divisor(T // 8)
    assert thg.launch_counts["hash_encode_normals_per_thread"] == (want == "per-thread")


@pytest.mark.parametrize("kernel", KERNELS)
def test_lane_groups_refused_at_f8(recorded, kernel):
    """The lane groups take F = 2 and 4: asked for at F = 8 they raise, and
    nothing is launched."""
    pos, table, g, u = _inputs(64, 3, 2**10, 8, 1)
    with pytest.raises(ValueError, match="lane-groups design takes F in"):
        _call(kernel, pos, table, g, u, dict(min_res=4, max_res=32, hash_table_size=2**10), _design="lane-groups")
    assert not recorded and thg.launch_counts == NO_HASH_LAUNCHES


def _misaligned(t):
    """A copy of ``t`` 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 4)[1 : t.numel() + 1].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("kernel,which", [("K3b", "table"), ("K3b", "grad"), ("K1bb", "table"), ("K1bb", "grad"),
                                          ("K1bb", "u")])
def test_lane_groups_refuse_a_misaligned_input_before_launching(recorded, kernel, which):
    """The lane groups read the table and the cotangent rows as 8- and
    16-byte vectors and take every array they are handed whole 16-byte
    aligned: a misaligned table, g or u raises ValueError in the wrapper,
    which takes no other design and launches nothing."""
    pos, table, g, u = _inputs(64, 8, 2**12, 4, 2)
    args = dict(table=table, grad=g, u=u)
    args[which] = _misaligned(args[which])
    with pytest.raises(ValueError, match="16-byte aligned"):
        _call(kernel, pos, args["table"], args["grad"], args["u"], dict(min_res=4, max_res=64, hash_table_size=2**12))
    assert not recorded and thg.launch_counts == NO_HASH_LAUNCHES


@pytest.mark.parametrize("which", ["d_table", "d_grad"])
def test_lane_limits_refuse_a_misaligned_gradient(which):
    """K1bb's gradients, which the wrapper allocates (aligned), are checked
    with the inputs: a misaligned d_table (its float4 reductions) or d_grad
    raises."""
    pos, table, g, u = _inputs(16, 8, 2**12, 4, 3)
    grads = dict(d_table=torch.zeros_like(table), d_grad=torch.empty_like(g))
    grads[which] = _misaligned(grads[which])
    with pytest.raises(ValueError, match="16-byte aligned"):
        thg._check_lane_limits(table, 16, grads["d_table"], g, u, grads["d_grad"])


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("design", list(thg.DESIGNS))
def test_normals_kernels_at_the_int32_boundary(recorded, kernel, design):
    """Both designs index in 32 bits: n * levels must stay below 2^31 (meta
    tensors, so nothing is allocated). At 2^31 - 1 the launch is reached,
    one more sample raises before it."""
    L, T, F = 8, 2**12, 4
    kw = dict(min_res=4, max_res=64, hash_table_size=T)

    def inputs(n):
        return (torch.empty((n, 3), device="meta"), torch.empty((L, T * F // 128, 128), device="meta"),
                torch.empty((n, L * F), device="meta"), torch.empty((n, 3), device="meta"))

    _call(kernel, *inputs((2**31 - 1) // L), kw, _design=design)
    assert len(recorded) == 1
    with pytest.raises(ValueError, match="2\\^31"):
        _call(kernel, *inputs(-(-(2**31) // L)), kw, _design=design)
    assert len(recorded) == 1


def test_cpu_normals_launch_nothing():
    """On CPU tensors the normals' derivatives run the twins: K3's position
    gradient (K3b) and K1's double backward (K1bb) count no launch in any
    counter, the per-thread design's included."""
    L, T, F = 4, 2**12, 4
    pos, table, g, u = _inputs(200, L, T, F, 4)
    kw = dict(num_levels=L, min_res=4, max_res=64, hash_table_size=T)
    thg.reset_launch_counts()
    p = pos.clone().requires_grad_()
    (d_exact,) = torch.autograd.grad(thg.hash_encode(p, table, block_exact=True, **kw), p, g)
    t = table.clone().requires_grad_()
    (d_block,) = torch.autograd.grad(thg.hash_encode(p, t, block=True, **kw), p, g, create_graph=True)
    d_p, d_t = torch.autograd.grad(d_block, (p, t), u)
    assert all(torch.isfinite(x).all() for x in (d_exact, d_block, d_p, d_t))
    assert thg.launch_counts == NO_HASH_LAUNCHES and "hash_encode_normals_per_thread" in thg.launch_counts


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n,L,T,F,lo,hi", [(3001, 8, 2**13, 4, 16, 512), (2000, 5, 3 * 2**10, 2, 7, 28),
                                           (33, 7, 2**12, 4, 4, 64)])
def test_normals_designs_match_the_float64_twin_on_the_card(cuda_device, kernel, n, L, T, F, lo, hi):
    """Both designs against the float64 twin on the card, each output within
    1e-5 of the twin's largest entry (float32 sums of a few dozen terms a
    sample, and K1bb's table gradient of a few hundred a lane, in another
    order); the lane groups' position gradient (and K1bb's d_grad) the
    same bits from run to run, and K1bb's d_grad the same bits in both
    designs (each sums a stencil's corners in corner order). Level counts
    that do and do not divide a warp, and a last warp with fewer samples."""
    pos, table, g, u = _inputs(n, L, T, F, 5, cuda_device)
    kw = dict(min_res=lo, max_res=hi, hash_table_size=T)
    if kernel == "K3b":
        want = (thg._block_exact_twin_bwd(pos, table, g, dtype=torch.float64, **kw),)
    else:
        scales = [2.0 * (1 - l % 2) for l in range(L)]
        want = thg._block_stochastic_twin_bwd_bwd(pos, table, g, u, scales, dtype=torch.float64, **kw)
    d_grads = []
    for design in thg.DESIGNS:
        got = _call(kernel, pos, table, g, u, kw, _design=design)
        got = (got,) if kernel == "K3b" else got
        again = _call(kernel, pos, table, g, u, kw, _design=design)
        again = (again,) if kernel == "K3b" else again
        torch.cuda.synchronize()
        for a, b, w in zip(got, again, want):
            assert float((a.double() - w).abs().max()) <= 1e-5 * float(w.abs().max()), design
        if design == "lane-groups":
            for k in (0,) if kernel == "K3b" else (0, 2):
                assert torch.equal(got[k].view(torch.int32), again[k].view(torch.int32)), (design, k)
        d_grads.append(got[0])
    if kernel == "K1bb":
        assert torch.equal(d_grads[0].view(torch.int32), d_grads[1].view(torch.int32))
