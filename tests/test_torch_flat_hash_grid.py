"""K7, the flat hash-grid layout, in the port against the JAX reference's
``hash_encode`` with neither block flag: the forward bit for bit, the VJP
for the table and the positions, on dense and hashed levels; the float64
backward twin that ``chip_smoke.py`` holds the kernel to; the proposal
density field that uses it; and the layout's traps.

The forward runs the same float32 operations in the same order (offsets,
corner weights ((wx*wy)*wz), bf16 reads, corners summed 0..7), so it is
compared with ``array_equal``. The VJP sums the same terms in another
order: the table gradient within 1e-6 of its peak, positions within 1e-5
of theirs (a sum of eight weight derivatives times res per level)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, NO_HASH_LAUNCHES, init_params, ray_positions, to_torch
from nerfstudio_tpu.core.rays import Frustums as JFrustums
from nerfstudio_tpu.core.rays import RaySamples as JRaySamples
from nerfstudio_tpu.fields.density_fields import HashMLPDensityField as JDensityField
from nerfstudio_tpu.ops.hash_grid import hash_encode as j_hash_encode
from nerfstudio_torch.core.rays import Frustums, RaySamples
from nerfstudio_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_torch.ops import hash_grid as thg
from nerfstudio_torch.ops.hash_grid import compute_level_resolutions, hash_encode
from nerfstudio_torch.utils.convert import params_from_jax

# (levels, min_res, max_res, log2 T, F): all dense; dense then hashed; the
# neus-facto proposal grid at T=2^15 (2 dense, 3 hashed levels; at its
# shipped 2^17 it has 3 and 2); F=1 and F=4.
CASES = {
    "dense": (3, 2, 8, 12, 2),
    "mixed": (4, 4, 24, 10, 2),
    "proposal": (5, 16, 128, 15, 2),
    "f1": (3, 4, 32, 10, 1),
    "f4": (3, 4, 32, 11, 4),
    # the proposal grid at ray-ordered positions (_torch_port.ray_positions):
    # the coarse levels' entries each take hundreds of terms (up to ~500
    # at level 0), as in the neus-facto step
    "proposal_rays": (5, 16, 128, 15, 2),
}


def _inputs(case, n=600, seed=0):
    L, lo, hi, log2_t, F = CASES[case]
    rng = np.random.default_rng(seed)
    if case.endswith("_rays"):
        pos = ray_positions(rng)
        table = rng.uniform(-1, 1, (L, 2**log2_t * F // 128, 128)).astype(np.float32)
        return pos, table, dict(num_levels=L, min_res=lo, max_res=hi, hash_table_size=2**log2_t)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    res = compute_level_resolutions(L, lo, hi)
    # exact vertices and cell centres of every level, and the cube's faces
    special = [0.0, 0.5, 1.0 - 2**-24] + [i / r for r in res for i in (1, r // 2, r - 1)]
    special = np.asarray(special, np.float32)
    pos[: len(special), 0] = special
    pos[: len(special), 1] = special[::-1]
    pos[len(special) : 2 * len(special), 2] = special
    table = rng.uniform(-1, 1, (L, 2**log2_t * F // 128, 128)).astype(np.float32)
    kw = dict(num_levels=L, min_res=lo, max_res=hi, hash_table_size=2**log2_t)
    return pos, table, kw


def test_cases_cover_dense_and_hashed_levels():
    dense = {}
    for case, (L, lo, hi, log2_t, _) in CASES.items():
        dense[case] = [(int(r) + 1) ** 3 <= 2**log2_t for r in compute_level_resolutions(L, lo, hi)]
    assert all(dense["dense"]) and dense["mixed"] == [True, True, False, False]
    assert dense["proposal"] == [True, True, False, False, False]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_is_bit_exact(case):
    pos, table, kw = _inputs(case)
    want = np.asarray(j_hash_encode(jnp.asarray(pos), jnp.asarray(table), **kw))
    got = hash_encode(to_torch(pos), to_torch(table), **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_vjp_matches_jax(case):
    pos, table, kw = _inputs(case, seed=1)
    g = np.random.default_rng(2).normal(size=(pos.shape[0], kw["num_levels"] * CASES[case][4])).astype(np.float32)
    _, vjp = jax.vjp(lambda p, t: j_hash_encode(p, t, **kw), jnp.asarray(pos), jnp.asarray(table))
    jp, jt = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    p, t = to_torch(pos).requires_grad_(True), to_torch(table).requires_grad_(True)
    hash_encode(p, t, **kw).backward(to_torch(g))
    np.testing.assert_allclose(t.grad.numpy(), jt, rtol=0, atol=1e-6 * np.abs(jt).max())
    np.testing.assert_allclose(p.grad.numpy(), jp, rtol=0, atol=1e-5 * np.abs(jp).max())


def test_batch_shape_and_table_only_gradient():
    """(..., 3) positions keep their batch shape; without position
    gradients only the table's is computed."""
    pos, table, kw = _inputs("mixed", n=64)
    t = to_torch(table).requires_grad_(True)
    out = hash_encode(to_torch(pos).view(8, 8, 3), t, **kw)
    assert out.shape == (8, 8, kw["num_levels"] * 2)
    out.sum().backward()
    assert t.grad is not None and t.grad.abs().sum() > 0


def test_table_gradient_is_float32_not_bf16():
    """bf16 rounding is the forward's read precision only: the table
    gradient is ``w * g`` scattered in float32, so a cotangent that bf16
    cannot hold comes back exactly (one sample at a vertex: weight 1)."""
    L, lo, hi, log2_t, F = CASES["dense"]
    kw = dict(num_levels=L, min_res=lo, max_res=hi, hash_table_size=2**log2_t)
    pos = torch.tensor([[0.0, 0.0, 0.0]])
    table = torch.full((L, 2**log2_t * F // 128, 128), 1.0 + 2**-12, requires_grad=True)
    out = hash_encode(pos, table, **kw)
    assert torch.all(out == 1.0)  # 1 + 2^-12 reads as bf16 1.0
    g = torch.full_like(out, 1.0 + 2**-20)
    out.backward(g)
    assert torch.all(table.grad[:, 0, :F] == 1.0 + 2**-20)  # entry 0 of every level, full float32
    assert float(table.grad.sum()) == pytest.approx(L * F * (1.0 + 2**-20), rel=1e-7)


def test_float64_twin_agrees():
    """The backward twin in float64 (chip_smoke.py's reference for the
    kernel) against the float32 one: the same corners, sums apart by float32
    rounding only."""
    pos, table, kw = _inputs("proposal", n=300, seed=3)
    kw.pop("num_levels")
    g = torch.randn((300, 10), generator=torch.Generator().manual_seed(0))
    t32, p32 = thg._flat_twin_bwd(to_torch(pos), to_torch(table), g, **kw)
    t64, p64 = thg._flat_twin_bwd(to_torch(pos), to_torch(table), g, dtype=torch.float64, **kw)
    assert t64.dtype == p64.dtype == torch.float64
    torch.testing.assert_close(t32.double(), t64, rtol=0, atol=1e-6 * float(t64.abs().max()))
    torch.testing.assert_close(p32.double(), p64, rtol=0, atol=1e-5 * float(p64.abs().max()))


def test_cpu_takes_the_twin():
    """On CPU tensors no kernel is launched; the flat path no longer raises."""
    pos, table, kw = _inputs("f1", n=32)
    thg.reset_launch_counts()
    p = to_torch(pos).requires_grad_(True)
    hash_encode(p, to_torch(table), **kw).sum().backward()
    assert thg.launch_counts == NO_HASH_LAUNCHES
    with pytest.raises(ValueError):
        hash_encode(p, to_torch(table), bwd_levels=(0,), **kw)


@pytest.mark.parametrize("contraction", [False, True])
def test_density_field_flat_matches_jax(contraction):
    """The proposal density field on the flat layout (neus-facto's, no
    contraction; and with it) against JAX's, from JAX's init with tables
    widened to +-1: density within 5e-2 relative where above 1e-3 (an exp
    of a bf16 MLP output), and the table gradient of the summed density
    within 5e-2 of its peak."""
    kw = dict(num_levels=4, base_res=4, max_res=64, log2_hashmap_size=11, hidden_dim=16,
              use_spatial_distortion=contraction, average_init_density=1.0)
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1.2, 1.2, (2000, 3)).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (2000, 1))
    z, one = np.zeros((2000, 1), np.float32), np.ones((2000, 1), np.float32)
    jrs = JRaySamples(frustums=JFrustums(origins=pos, directions=d, starts=z, ends=z, pixel_area=one))
    trs = RaySamples(frustums=Frustums(*(to_torch(x) for x in (pos, d, z, z, one))))
    jf = JDensityField(**kw)
    params = init_params(lambda k: jf.init(k, jrs, method=JDensityField.get_density), 5)
    tf = HashMLPDensityField(device=CPU, **kw)
    assert not (tf.mlp_base.encoding.block or tf.mlp_base.encoding.block_exact)
    tf.load_state_dict(params_from_jax(params, tf))

    def jdens(p):
        return jf.apply(p, jrs, method=JDensityField.get_density)[0]

    want, vjp = jax.vjp(jdens, params)
    (jgrad,) = vjp(jnp.ones_like(want))
    got, _ = tf.get_density(trs)
    got.sum().backward()
    want = np.asarray(want)
    big = want > 1e-3
    np.testing.assert_allclose(got.detach().numpy()[big], want[big], rtol=5e-2)
    np.testing.assert_allclose(got.detach().numpy()[~big], want[~big], atol=1e-3)
    jt = np.asarray(jgrad["params"]["mlp_base"]["encoding"]["hash_table"])
    np.testing.assert_allclose(tf.mlp_base.encoding.hash_table.grad.numpy(), jt, rtol=0,
                               atol=5e-2 * np.abs(jt).max())
