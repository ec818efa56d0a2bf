"""Parity of the port's K1 backward with the JAX reference: the twin that CPU
tensors take (through ``hash_encode``'s autograd) against ``jax.vjp`` of
``hash_encode(block=True, bwd_levels=..., bwd_scale=...)`` on the same
positions, table and cotangent. The CUDA kernel is held against the same
twin on the card by chip_smoke.py.

Tolerances, per level, relative to the level's largest gradient entry:
* d_table on scatter levels 1e-5: both sum the same float32 products
  (w8[c] * g), in another order;
* d_table on one-hot levels (the reference's ``_row_gather_block_tw_oh``,
  dense levels of <= 2048 used rows) 1e-2: the reference rounds the
  weighted gradient row to bf16 (one bf16 ulp is 2^-8 relative) before its
  one-hot matmul, which the port does not copy;
* d_positions 1e-5 of the largest entry: float32 sums over corners and
  levels in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NO_HASH_LAUNCHES, ray_positions
from nerfstudio_tpu.ops import hash_grid as jhg
from nerfstudio_torch.ops import hash_grid as thg

# (L, T, F, min_res, max_res): each mixes dense and hashed levels. The
# first three have only one-hot dense levels; the last keeps level 1 (res
# 14, 8^3 blocks) on the dense threshold; the (4, 2^16, 8) case has a dense
# level with 3430 used rows, which the reference scatters like a hashed one.
CASES = [
    (4, 2**12, 2, 4, 64),
    (4, 2**10, 4, 2, 48),
    (4, 2**16, 8, 8, 80),
    (3, 2**12, 2, 7, 28),
    (4, 2**12, 4, 4, 64),
]
# Cases run at ray-ordered positions (_torch_port.ray_positions, running out
# of the cube at both ends): the coarse levels' entries each take hundreds
# of terms, as in the training step, whose inputs chip_smoke.py holds every
# backward design to this twin at.
RAY_CASES = {(4, 2**12, 4, 4, 64)}
SUBSETS = {"all": None, "P2": "even", "none": ()}


def _positions(n, seed, resolutions):
    """Uniform positions, positions outside the cube, and exact cell
    corners (x*res an integer in float32, the tie of the offset's clip) at
    every level: 0, 1, and multiples of 1/res for power-of-two factors of
    res."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    edge = [0.0, 1.0, -0.1, 1.1, 0.5]
    for res in resolutions:
        edge += [k / res for k in (1, 2, 3, res // 2 + 1, res - 1)]
    edge = np.asarray(edge, np.float32)
    idx = rng.integers(0, len(edge), (600, 3))
    corners = edge[idx]
    # mix corner axes with random ones, so a tie meets live weights on the
    # other axes
    mixed = np.where(rng.uniform(size=(600, 3)) < 0.5, corners, rng.uniform(0, 1, (600, 3)))
    return np.concatenate([pos, corners, mixed]).astype(np.float32)


def _bwd_levels(subset, L):
    spec = SUBSETS[subset]
    if spec == "even":
        return tuple(l for l in range(L) if l % 2 == 0)
    return spec


def _run_both(L, T, F, min_res, max_res, bwd_levels, scale, seed=0, n=2500):
    res = [int(r) for r in jhg.compute_level_resolutions(L, min_res, max_res)]
    if (L, T, F, min_res, max_res) in RAY_CASES:
        pos = ray_positions(np.random.default_rng(seed), clip=False)
    else:
        pos = _positions(n, seed, res)
    rng = np.random.default_rng(seed + 1)
    table = rng.uniform(-1.0, 1.0, (L, T * F // 128, 128)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (pos.shape[0], L * F)).astype(np.float32)
    kw = dict(num_levels=L, min_res=min_res, max_res=max_res, hash_table_size=T, block=True,
              bwd_levels=bwd_levels, bwd_scale=scale)
    out, vjp = jax.vjp(lambda p, t: jhg.hash_encode(p, t, **kw), jnp.asarray(pos), jnp.asarray(table))
    j_dpos, j_dtab = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    tp = torch.from_numpy(pos).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    thg.reset_launch_counts()
    t_out = thg.hash_encode(tp, tt, **kw)
    t_out.backward(torch.from_numpy(g))
    assert thg.launch_counts == NO_HASH_LAUNCHES
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), rtol=0, atol=1e-6)
    return pos, res, (j_dpos, j_dtab), (tp.grad.numpy(), tt.grad.numpy())


def _onehot_level(res, T, F):
    rows = jhg._block_level_rows_used(res, T, F)
    return rows is not None and rows <= jhg._ONEHOT_BWD_MAX_ROWS


@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("L,T,F,min_res,max_res", CASES)
def test_k1_backward_twin_matches_jax_vjp(L, T, F, min_res, max_res, subset):
    bwd_levels = _bwd_levels(subset, L)
    scale = 2.0 if subset == "P2" else 1.0
    pos, res, (j_dpos, j_dtab), (t_dpos, t_dtab) = _run_both(L, T, F, min_res, max_res, bwd_levels, scale)
    kinds = set()
    for l in range(L):
        active = bwd_levels is None or l in bwd_levels
        if not active:
            assert not t_dtab[l].any() and not j_dtab[l].any(), l
            continue
        oh = _onehot_level(res[l], T, F)
        kinds.add("onehot" if oh else ("dense" if thg._block_level_layout(res[l], T)[1] else "hashed"))
        peak = np.abs(j_dtab[l]).max()
        assert peak > 0
        np.testing.assert_allclose(t_dtab[l], j_dtab[l], rtol=0, atol=(1e-2 if oh else 1e-5) * peak, err_msg=f"level {l}")
    if subset == "all":
        assert "onehot" in kinds and "hashed" in kinds
        if T == 2**16:
            assert "dense" in kinds  # a dense level past the one-hot row limit
    np.testing.assert_allclose(t_dpos, j_dpos, rtol=0, atol=1e-5 * np.abs(j_dpos).max())
    # outside the cube the offset is clipped: no position gradient
    out = np.any((pos < 0) | (pos > 1), axis=-1)
    assert out.sum() > 10
    outside_axes = (pos < 0) | (pos > 1)
    assert not t_dpos[outside_axes].any() and not j_dpos[outside_axes].any()


def test_k1_backward_half_gradient_at_exact_cell_corners():
    """The trap: jnp.clip differentiates as 1/2 where x*res is an exact
    integer (and at x = 1), torch.clamp as 1. At such positions the port's
    position gradient must be JAX's, which is half of what the open-cell
    derivative would give."""
    L, T, F = 1, 2**12, 4
    res = 16
    pos = np.array([[0.5, 0.3, 0.7], [4 / 16, 0.41, 0.9], [0.3, 0.0, 0.55], [1.0, 0.62, 0.2]], np.float32)
    assert np.any(pos * res == np.round(pos * res), axis=-1).all()
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (L, T * F // 128, 128)).astype(np.float32)
    g = rng.normal(0, 1, (pos.shape[0], L * F)).astype(np.float32)
    kw = dict(num_levels=L, min_res=res, max_res=res, hash_table_size=T, block=True)
    _, vjp = jax.vjp(lambda p: jhg.hash_encode(p, jnp.asarray(table), **kw), jnp.asarray(pos))
    j_dpos = np.asarray(vjp(jnp.asarray(g))[0])
    tp = torch.from_numpy(pos).requires_grad_()
    thg.hash_encode(tp, torch.from_numpy(table), **kw).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tp.grad.numpy(), j_dpos, rtol=1e-5, atol=1e-5)  # float32 sum order
    # the tie axes carry a gradient, and it is half the one-sided derivative
    tie = pos * res == np.round(pos * res)
    even_tie = tie & ((np.floor(np.minimum(pos * res, res - 1)).astype(int) % 2) == 0)
    assert even_tie.sum() >= 3 and np.abs(j_dpos[even_tie]).min() > 0
    with torch.no_grad():
        clamp_grad = _one_sided_position_grad(pos, table, g, res, T)
    np.testing.assert_allclose(tp.grad.numpy()[even_tie], 0.5 * clamp_grad[even_tie], rtol=1e-5, atol=1e-7)


def _one_sided_position_grad(pos, table, g, res, T):
    """The position gradient with the clip's derivative taken as 1 on the
    bounds (torch.clamp's choice), through the twin's own geometry."""
    import nerfstudio_torch.ops.hash_grid as mod

    saved = mod._clip01
    mod._clip01 = lambda x: torch.clamp(x, 0.0, 1.0)
    try:
        with torch.enable_grad():
            tp = torch.from_numpy(pos).requires_grad_()
            d_tab, d_pos = mod._block_stochastic_twin_bwd(
                tp.detach(), torch.from_numpy(table), torch.from_numpy(g), [1.0],
                min_res=res, max_res=res, hash_table_size=T,
            )
    finally:
        mod._clip01 = saved
    return d_pos.numpy()


@pytest.mark.parametrize("need", ["positions", "table"])
def test_k1_backward_returns_only_what_is_asked(need):
    L, T, F = 2, 2**10, 4
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.uniform(0, 1, (64, 3)).astype(np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T * F // 128, 128)).astype(np.float32))
    pos.requires_grad_(need == "positions")
    table.requires_grad_(need == "table")
    out = thg.hash_encode(pos, table, num_levels=L, min_res=4, max_res=16, hash_table_size=T, block=True)
    out.sum().backward()
    assert (pos.grad is not None) == (need == "positions")
    assert (table.grad is not None) == (need == "table")


def test_float64_twin_agrees_with_float32_twin():
    """The float64 run (chip_smoke.py's reference for the kernel) takes the
    same blocks as the float32 one: the geometry stays float32."""
    L, T, F = 3, 2**12, 2
    rng = np.random.default_rng(9)
    pos = torch.from_numpy(rng.uniform(0, 1, (3000, 3)).astype(np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (L, T * F // 128, 128)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (3000, L * F)).astype(np.float32))
    kw = dict(min_res=4, max_res=40, hash_table_size=T)
    d32 = thg._block_stochastic_twin_bwd(pos, table, g, [2.0, 0.0, 2.0], **kw)
    d64 = thg._block_stochastic_twin_bwd(pos, table, g, [2.0, 0.0, 2.0], dtype=torch.float64, **kw)
    assert d64[0].dtype == torch.float64
    torch.testing.assert_close(d32[0].double(), d64[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(d32[1].double(), d64[1], rtol=0, atol=1e-3 * float(d64[1].abs().max()))
