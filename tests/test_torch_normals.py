"""nerfacto with predicted normals, the port against the JAX reference on
the CPU: K3's position gradient (K3b) and K1's second derivative (K1bb)
against JAX's autodiff, the plain K1bb against the autograd of the twice
differentiable K1 backward twin, trunc_exp's second derivative, the
predicted-normal head, the field's normals in training and in eval, the two
losses, one nerfacto step with ``predict_normals`` (every loss term and
every gradient, the pose adjustment's too), one eval chunk's normals and
a converted checkpoint. Inputs are drawn with numpy from a seed.

Tolerances, each with its reason:
* K3b and K1bb's position and cotangent outputs, 1e-5 of the peak (2e-5
  for the second derivative in the positions, whose terms carry res^2):
  both sides sum the same float32 products in another order;
* K1bb's table gradient against JAX in bfloat16 units: JAX sums it in
  bfloat16 (the gradient of the bf16 row gather ``table.astype(bf16)[rows]``
  is a bf16 scatter-add), the port in float32. An entry of k terms of
  magnitudes summing to A is off by at most (k + 1) 2^-8 A: each term's
  rounding to bf16 and each of the k - 1 partial sums' (2^-8 the bf16 unit
  roundoff). The port's sum is also held to its own float32 twin's
  autograd at 1e-5 of the peak, and the uniform-position cases keep most
  entries at a few terms, where the bound is a few bf16 roundings;
* the field, the step and the eval chunk: see their docstrings.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, NO_HASH_LAUNCHES, NUM_IMAGES, TINY_MODEL, init_params, jax_step_draws, ray_positions, \
    to_torch
from fixtures import make_nerfstudio_fixture
from test_torch_instant_ngp import jax_float32_mlps
from nerfstudio_tpu.core.rays import Frustums as JFrustums
from nerfstudio_tpu.core.rays import RaySamples as JRaySamples
from nerfstudio_tpu.field_components import field_heads as jheads
from nerfstudio_tpu.field_components.activations import trunc_exp as j_trunc_exp
from nerfstudio_tpu.model_components import losses as jlosses
from nerfstudio_tpu.ops import hash_grid as jhg
from nerfstudio_torch.core.rays import Frustums, RaySamples
from nerfstudio_torch.field_components.activations import trunc_exp
from nerfstudio_torch.field_components.field_heads import FieldHeadNames, PredNormalsFieldHead
from nerfstudio_torch.model_components import losses
from nerfstudio_torch.ops import hash_grid as thg
from nerfstudio_torch.utils.convert import params_from_jax

# (L, T, F, min_res, max_res): dense and hashed levels at F 2 and 4
CASES = [(4, 2**12, 4, 4, 64), (3, 2**10, 2, 2, 40), (2, 2**12, 2, 8, 96)]
BF16_U = 2.0**-8


def _positions(n, seed, resolutions):
    """Uniform positions, a few outside the cube, and exact cell corners
    (x*res an integer: the clip's tie, whose derivative is 1/2) at every
    level, mixed with uniform axes."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3))
    edge = [0.0, 1.0, -0.1, 1.1, 0.5] + [k / r for r in resolutions for k in (1, 2, 3, r // 2 + 1, r - 1)]
    edge = np.asarray(edge)
    corners = edge[rng.integers(0, len(edge), (200, 3))]
    mixed = np.where(rng.uniform(size=(200, 3)) < 0.5, corners, rng.uniform(0, 1, (200, 3)))
    return np.concatenate([pos, corners, mixed]).astype(np.float32)


def _inputs(L, T, F, min_res, max_res, seed, rays=False):
    res = [int(r) for r in thg.compute_level_resolutions(L, min_res, max_res)]
    pos = ray_positions(np.random.default_rng(seed), samples=400, clip=False) if rays else _positions(600, seed, res)
    rng = np.random.default_rng(seed + 1)
    table = rng.uniform(-1.0, 1.0, (L, T * F // 128, 128)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (pos.shape[0], L * F)).astype(np.float32)
    u = rng.normal(0.0, 1.0, (pos.shape[0], 3)).astype(np.float32)
    return pos, table, g, u


def _close(got, ref, rel, what):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-30, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"L{c[0]}_T{c[1].bit_length() - 1}_F{c[2]}")
def test_k3_position_gradient_matches_jax_grad(case):
    """K3b's twin, through ``hash_encode(block_exact=True)``'s autograd,
    against ``jax.vjp`` in the positions of JAX's exact trilerp; a table
    gradient through K3 raises."""
    L, T, F, min_res, max_res = case
    pos, table, g, _ = _inputs(*case, seed=3)
    kw = dict(num_levels=L, min_res=min_res, max_res=max_res, hash_table_size=T, block_exact=True)
    out, vjp = jax.vjp(lambda p: jhg.hash_encode(p, jnp.asarray(table), **kw), jnp.asarray(pos))
    (j_dpos,) = vjp(jnp.asarray(g))
    tp = torch.from_numpy(pos).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    thg.reset_launch_counts()
    t_out = thg.hash_encode(tp, tt, **kw)
    (t_dpos,) = torch.autograd.grad(t_out, tp, torch.from_numpy(g), retain_graph=True)
    assert thg.launch_counts == NO_HASH_LAUNCHES
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), rtol=0, atol=1e-6)
    _close(t_dpos.numpy(), np.asarray(j_dpos), 1e-5, "d_positions")
    # the explicit twin (the card's oracle, which the CPU path runs) against
    # autograd through the forward twin
    geom = dict(min_res=min_res, max_res=max_res, hash_table_size=T)
    p2 = torch.from_numpy(pos).requires_grad_()
    (auto,) = torch.autograd.grad(thg._block_exact_twin(p2, torch.from_numpy(table), **geom), p2, torch.from_numpy(g))
    _close(t_dpos.numpy(), auto.numpy(), 1e-6, "autograd through the forward twin")
    with pytest.raises(NotImplementedError, match="table gradient"):
        torch.autograd.grad(t_out, tt, torch.from_numpy(g))


def _jax_second(pos, table, g, u, kw):
    """JAX's grad of <d_positions, u> in (positions, table, cotangent), with
    d_positions the vjp of ``hash_encode`` in the positions."""

    def outer(p, t, c):
        _, vjp = jax.vjp(lambda q: jhg.hash_encode(q, t, **kw), p)
        return jnp.sum(vjp(c)[0] * jnp.asarray(u))

    return [np.asarray(x) for x in jax.grad(outer, argnums=(0, 1, 2))(jnp.asarray(pos), jnp.asarray(table),
                                                                       jnp.asarray(g))]


def _port_second(pos, table, g, u, kw):
    tp, tt, tg = (torch.from_numpy(x).requires_grad_() for x in (pos, table, g))
    out = thg.hash_encode(tp, tt, **kw)
    (d,) = torch.autograd.grad(out, tp, tg, create_graph=True)
    return [x.numpy() for x in torch.autograd.grad((d * torch.from_numpy(u)).sum(), (tp, tt, tg))]


def _table_terms(pos, table, g, u, scales, geom):
    """Per table entry: (the number k of second-order terms, their summed
    magnitudes A), in float64 over the port's geometry."""
    L, S, lanes = table.shape
    F = 128 * S // geom["hash_table_size"]
    n = pos.shape[0]
    k = torch.zeros((L, S * lanes), dtype=torch.float64)
    a = torch.zeros((L, S * lanes), dtype=torch.float64)
    ua = torch.from_numpy(u).abs().double()
    for l, res in enumerate(thg.compute_level_resolutions(L, geom["min_res"], geom["max_res"])):
        if not scales[l]:
            continue
        idx, phi, dphi = thg._stochastic_level(torch.from_numpy(pos), int(res), geom["hash_table_size"], F)
        habs = []
        for c in range(8):
            bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            p = [phi[x][bits[x]].double().abs() for x in range(3)]
            d = [dphi[x][bits[x]].double().abs() for x in range(3)]
            habs.append(ua[:, 0] * d[0] * p[1] * p[2] + ua[:, 1] * p[0] * d[1] * p[2] + ua[:, 2] * p[0] * p[1] * d[2])
        habs = torch.stack(habs, dim=-1)
        ga = torch.from_numpy(g[:, l * F:(l + 1) * F]).abs().double()
        a[l].index_add_(0, idx.reshape(-1), (scales[l] * habs[:, :, None] * ga[:, None, :]).reshape(-1))
        k[l].index_add_(0, idx.reshape(-1), (habs[:, :, None] > 0).expand(n, 8, F).reshape(-1).double())
    return k.view(L, S, lanes).numpy(), a.view(L, S, lanes).numpy()


# (case, bwd_levels subset): both phases of the period-2 cycle and the whole
# backward at L4 F4; F2 with dense and hashed levels; the ray-ordered samples
SECOND_CASES = [(CASES[0], "all"), (CASES[0], "P2_even"), (CASES[0], "P2_odd"), (CASES[1], "P2_odd"),
                (CASES[2], "all"), ("rays", "P2_even")]


@pytest.mark.parametrize("case,subset", SECOND_CASES, ids=lambda c: c if isinstance(c, str) else
                         f"L{c[0]}_T{c[1].bit_length() - 1}_F{c[2]}")
def test_k1_second_derivative_matches_jax(case, subset):
    """K1's backward differentiated again (the port's ``_BlockEncodeBwd``
    backward, the plain K1bb on the CPU) against JAX's ``grad`` of its
    ``vjp``: the cotangent's gradient and the positions' within float32
    summation order, the table's in bfloat16 units (module docstring),
    levels outside ``bwd_levels`` without a table gradient on both sides;
    both phases of the period-2 cycle and the whole backward. "rays": the
    training step's ray-ordered samples, hundreds of terms an entry."""
    rays = case == "rays"
    L, T, F, min_res, max_res = CASES[0] if rays else case
    pos, table, g, u = _inputs(L, T, F, min_res, max_res, seed=5, rays=rays)
    levels = {"all": None, "P2_even": tuple(range(0, L, 2)), "P2_odd": tuple(range(1, L, 2))}[subset]
    kw = dict(num_levels=L, min_res=min_res, max_res=max_res, hash_table_size=T, block=True, bwd_levels=levels,
              bwd_scale=1.0 if levels is None else 2.0)
    j_dp, j_dt, j_dg = _jax_second(pos, table, g, u, kw)
    t_dp, t_dt, t_dg = _port_second(pos, table, g, u, kw)
    _close(t_dg, j_dg, 1e-5, "d_grad")
    _close(t_dp, j_dp, 2e-5, "d_positions")
    scales = [1.0 if levels is None else (2.0 if l in levels else 0.0) for l in range(L)]
    k, a = _table_terms(pos, table, g, u, scales, dict(min_res=min_res, max_res=max_res, hash_table_size=T))
    for l in range(L):
        if not scales[l]:
            assert not t_dt[l].any() and not j_dt[l].any(), l
            continue
        assert np.abs(j_dt[l]).max() > 0
        err = np.abs(t_dt[l].astype(np.float64) - j_dt[l])
        bound = (k[l] + 1) * BF16_U * a[l] + 1e-30
        assert (err <= bound).all(), (l, float((err / bound).max()))
    # the position gradient outside the cube is zero on every axis that is
    assert not t_dp[(pos < 0) | (pos > 1)].any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"L{c[0]}_T{c[1].bit_length() - 1}_F{c[2]}")
def test_plain_k1bb_matches_the_twins_autograd(case):
    """The explicit plain K1bb (the card's oracle) against autograd through
    ``_block_stochastic_twin_bwd(create_graph=True)``, the twice
    differentiable K1 backward twin (its gradient scale as the reference's
    ``_grad_scale``, its bf16 rounding passing the gradient unrounded): every
    output within float32 summation order."""
    L, T, F, min_res, max_res = case
    pos, table, g, u = _inputs(*case, seed=7)
    geom = dict(min_res=min_res, max_res=max_res, hash_table_size=T)
    scales = [2.0 if l % 2 else 0.0 for l in range(L)]
    tp, tt, tg = (torch.from_numpy(x).requires_grad_() for x in (pos, table, g))
    _, d_pos = thg._block_stochastic_twin_bwd(tp, tt, tg, scales, create_graph=True, **geom)
    auto = torch.autograd.grad((d_pos * torch.from_numpy(u)).sum(), (tg, tt, tp))
    plain = thg._block_stochastic_twin_bwd_bwd(torch.from_numpy(pos), torch.from_numpy(table), torch.from_numpy(g),
                                               torch.from_numpy(u), scales, **geom)
    for what, a, b in zip(("d_grad", "d_table", "d_positions"), plain, auto):
        _close(a.numpy(), b.numpy(), 1e-5, what)
    # the first order of the create_graph twin is the plain twin's
    _, first = thg._block_stochastic_twin_bwd(torch.from_numpy(pos), torch.from_numpy(table), torch.from_numpy(g),
                                              scales, **geom)
    _close(d_pos.detach().numpy(), first.numpy(), 1e-6, "first order")
    # asked for less, it computes less
    dg, dt, dp = thg._block_stochastic_twin_bwd_bwd(torch.from_numpy(pos), torch.from_numpy(table),
                                                    torch.from_numpy(g), torch.from_numpy(u), scales,
                                                    need_table=False, need_positions=False, **geom)
    assert dt is None and dp is None and torch.equal(dg, plain[0])


def test_k1_table_gradient_cotangent_raises():
    """No reference path differentiates K1's table gradient: asking for it
    raises, and the normals' position gradient (a table that requires a
    gradient, not asked for) scatters none."""
    L, T, F, min_res, max_res = CASES[0]
    pos, table, g, _ = _inputs(*CASES[0], seed=9)
    tp, tt = torch.from_numpy(pos).requires_grad_(), torch.from_numpy(table).requires_grad_()
    kw = dict(num_levels=L, min_res=min_res, max_res=max_res, hash_table_size=T, block=True)
    (g_table,) = torch.autograd.grad(thg.hash_encode(tp, tt, **kw), tt, torch.from_numpy(g), create_graph=True)
    with pytest.raises(NotImplementedError, match="table gradient"):
        torch.autograd.grad(g_table.square().sum(), tp)
    seen = []
    saved = thg._block_stochastic_twin_bwd

    def spy(*args, **kwargs):
        seen.append(list(args[3]))
        return saved(*args, **kwargs)

    thg._block_stochastic_twin_bwd = spy
    try:
        torch.autograd.grad(thg.hash_encode(tp, tt, **kw), tp, torch.from_numpy(g))
    finally:
        thg._block_stochastic_twin_bwd = saved
    assert seen == [[0.0] * L]  # no level's table gradient computed


def test_trunc_exp_second_derivative_matches_jax():
    """trunc_exp's derivative of its derivative, ``exp(clip(x, -15, 15)) *
    clip'(x)`` with 1/2 on the bounds (jnp.clip's max/min pair), against
    JAX's autodiff of its ``custom_vjp`` backward; the gradient's cotangent
    path too."""
    x = np.array([-40, -15.5, -15, -14.99, -1, 0, 0.5, 3, 14.99, 15, 15.5, 29, 30, 31], np.float32)
    w = np.linspace(0.5, 2.0, x.size).astype(np.float32)

    def jd(v, c):
        return jnp.sum(jax.grad(lambda y: jnp.sum(j_trunc_exp(y) * c))(v) * jnp.asarray(w))

    j_dx, j_dc = (np.asarray(a) for a in jax.grad(jd, argnums=(0, 1))(jnp.asarray(x), jnp.ones_like(jnp.asarray(x))))
    tx, tc = torch.from_numpy(x).requires_grad_(), torch.ones(x.size, requires_grad=True)
    (d,) = torch.autograd.grad((trunc_exp(tx) * tc).sum(), tx, create_graph=True)
    t_dx, t_dc = torch.autograd.grad((d * torch.from_numpy(w)).sum(), (tx, tc))
    np.testing.assert_allclose(t_dx.numpy(), j_dx, rtol=1e-6, atol=0)
    np.testing.assert_allclose(t_dc.numpy(), j_dc, rtol=1e-6, atol=0)
    assert t_dx[2] == 0.5 * t_dc[2] and t_dx[0] == 0  # the tie's half, nothing outside


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pred_normals_head_matches_jax(dtype):
    """The head: a linear layer to three outputs, tanh, divided by the norm
    floored at 1e-6. float32 within 1e-6; bfloat16 products (as shipped)
    within 1e-2: a bf16 ulp of an input or product flips one way or the
    other on the two sides."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (500, 64)).astype(np.float32)
    x[0] = 0.0  # tanh(bias 0) = 0: the floor, a zero normal on both sides
    jh = jheads.PredNormalsFieldHead(dtype=getattr(jnp, dtype))
    params = init_params(lambda k: jh.init(k, jnp.asarray(x)), 12)
    th = PredNormalsFieldHead(64, device=CPU)
    th.dtype = getattr(torch, dtype)
    th.layer.weight.data = torch.from_numpy(np.asarray(params["params"]["Dense_0"]["kernel"]).T.copy())
    th.layer.bias.data = torch.from_numpy(np.asarray(params["params"]["Dense_0"]["bias"]).copy())
    ref = np.asarray(jh.apply(params, jnp.asarray(x)))
    got = th(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 if dtype == "float32" else 1e-2)
    assert not got[0].any() and not ref[0].any()
    np.testing.assert_allclose(np.linalg.norm(got[1:], axis=-1), 1.0, atol=1e-5)


def test_normal_losses_match_jax():
    """orientation_loss and pred_normal_loss on the same weights, normals
    and directions (float32 sums of the same products: 1e-6 relative), and
    their gradients."""
    rng = np.random.default_rng(13)
    w = rng.uniform(0, 0.3, (64, 12, 1)).astype(np.float32)
    n = rng.normal(size=(64, 12, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    p = rng.normal(size=(64, 12, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for jfn, tfn, args in ((jlosses.orientation_loss, losses.orientation_loss, (w, n, d)),
                           (jlosses.pred_normal_loss, losses.pred_normal_loss, (w, n, p))):
        ref, jgrads = jax.value_and_grad(lambda *a: jnp.sum(jfn(*a) ** 2), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in args))
        targs = [torch.from_numpy(a).requires_grad_() for a in args]
        got = (tfn(*targs) ** 2).sum()
        got.backward()
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
        for a, b in zip(targs, jgrads):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=0, atol=1e-6 * np.abs(b).max() + 1e-12)
    assert float(losses.orientation_loss(*(torch.from_numpy(a) for a in (w, n, d))).min()) >= 0


def test_render_normals_matches_jax():
    """``render_normals``: the weighted sum of the samples' normals, divided
    by its norm floored at 1e-10 (a ray of zero weights gives 0), and its
    gradients, against JAX's on the same inputs (float32, 1e-6)."""
    from nerfstudio_tpu.model_components import renderers as jrenderers
    from nerfstudio_torch.model_components import renderers

    rng = np.random.default_rng(17)
    w = rng.uniform(0, 0.3, (32, 10, 1)).astype(np.float32)
    w[0] = 0.0
    n = rng.normal(size=(32, 10, 3)).astype(np.float32)
    c = rng.normal(size=(32, 3)).astype(np.float32)
    ref, jgrads = jax.value_and_grad(lambda a, b: jnp.sum(jrenderers.render_normals(b, a)[1:] * c[1:]),
                                     argnums=(0, 1))(jnp.asarray(w), jnp.asarray(n))
    tw, tn = torch.from_numpy(w).requires_grad_(), torch.from_numpy(n).requires_grad_()
    out = renderers.render_normals(tn, tw)
    assert not out[0].any()
    (out[1:] * torch.from_numpy(c[1:])).sum().backward()
    np.testing.assert_allclose(out[1:].detach().numpy(), np.asarray(jrenderers.render_normals(n, w))[1:], atol=1e-6)
    for a, b in zip((tw.grad, tn.grad), jgrads):
        np.testing.assert_allclose(a.numpy()[1:], np.asarray(b)[1:], rtol=0, atol=1e-6 * np.abs(b[1:]).max())


# --------------------------------------------------------------------------
# the field, the model


def pair_constant_table(shape, min_res, max_res, T, rng):
    """An (L, S, 128) table on which K1's stochastic rounding changes no
    value: on a dense level the value of vertex v is drawn per ((v + 1) >> 1)
    on each axis (an odd cell's two vertices, between which the coin
    chooses, hold one value; an even cell interpolates between two), a
    hashed level is flat (one value per feature). The dense levels keep a
    density gradient, so the normals live, and the two packages agree
    though their sample positions differ in the last bits."""
    L, S, _ = shape
    F = 128 * S // T
    bpr = 16 // F
    out = np.zeros((L, S * 128), np.float32)
    for l, res in enumerate(thg.compute_level_resolutions(L, min_res, max_res)):
        bs, dense = thg._block_level_layout(int(res), T)
        if not dense:
            out[l] = np.tile(rng.uniform(-1, 1, F).astype(np.float32), S * 128 // F)
            continue
        values = rng.uniform(-1, 1, (bs + 1, bs + 1, bs + 1, F)).astype(np.float32)
        b = np.arange(bs**3)
        coords = (b // (bs * bs), (b // bs) % bs, b % bs)
        for c in range(8):
            q = [(2 * coords[a] + ((c >> (2 - a)) & 1) + 1) >> 1 for a in range(3)]
            lanes = (b // bpr) * 128 + (b % bpr) * (8 * F) + c * F
            out[l, lanes[:, None] + np.arange(F)] = values[q[0], q[1], q[2]]
    return out.reshape(shape)


@contextlib.contextmanager
def jax_float32_field():
    """JAX's nerfacto field with every MLP (``jax_float32_mlps``) and the
    predicted-normal head in float32, while a model is traced inside."""
    import nerfstudio_tpu.fields.nerfacto_field as jfield

    saved = jfield.PredNormalsFieldHead
    jfield.PredNormalsFieldHead = functools.partial(saved, dtype=jnp.float32)
    try:
        with jax_float32_mlps():
            yield
    finally:
        jfield.PredNormalsFieldHead = saved


def float32_field(module):
    """The port's MLPs and field heads of ``module`` computing in float32."""
    from nerfstudio_torch.field_components.field_heads import FieldHead
    from nerfstudio_torch.field_components.mlp import MLP

    for m in module.modules():
        if isinstance(m, (MLP, FieldHead)):
            m.dtype = torch.float32
    return module


# every level dense (resolutions 4, 6, 11, 20 at T=2^14), so a pair-constant
# table keeps a density gradient on all of them
FIELD = dict(num_images=4, num_levels=4, base_res=4, max_res=20, log2_hashmap_size=14, features_per_level=4,
             hidden_dim=16, hidden_dim_color=16, appearance_embedding_dim=8, average_init_density=1.0,
             hash_block=True, use_pred_normals=True)


def live_gradient(pos, min_res, max_res, T, contract=True):
    """Which samples keep a density gradient under K1 with a pair-constant
    table: those with an axis in an even cell at some dense level (K1's
    weights on an odd axis are the coin's constants). At a zero density
    gradient the reference's normals ``-g / max(|g|, 1e-10)`` are 0 on both
    sides, but JAX differentiates ``jnp.linalg.norm`` there to NaN (0 times
    the infinite slope of its sqrt) and the port to 0, so the parity tests
    of the normals' gradients hold the other samples
    (``test_zero_density_gradient_gives_zero_normals``)."""
    from nerfstudio_torch.field_components.spatial_distortions import SceneContraction

    x = torch.from_numpy(pos)
    x = (SceneContraction("inf")(x) + 2.0) / 4.0 if contract else x
    keep = torch.zeros(x.shape[:-1], dtype=torch.bool)
    for res in thg.compute_level_resolutions(FIELD["num_levels"] if contract else 1, min_res, max_res):
        if thg._block_level_layout(int(res), T)[1]:
            cells = torch.clamp(torch.floor(x * int(res)), 0, int(res) - 1).to(torch.int64)
            keep |= ((cells % 2) == 0).any(dim=-1)
    return keep.numpy()


def _field_samples(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    pos = pos[live_gradient(pos, FIELD["base_res"], FIELD["max_res"], 2**FIELD["log2_hashmap_size"])]
    n = pos.shape[0]
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z, one = np.zeros((n, 1), np.float32), np.ones((n, 1), np.float32)
    jrs = JRaySamples(frustums=JFrustums(origins=pos, directions=d, starts=z, ends=z, pixel_area=one))
    trs = RaySamples(frustums=Frustums(*(to_torch(x) for x in (pos, d, z, z, one))))
    return jrs, trs


def _field_pair(train, seed=17):
    from nerfstudio_tpu.fields.nerfacto_field import NerfactoField as JNerfactoField
    from nerfstudio_torch.fields.nerfacto_field import NerfactoField

    jrs, trs = _field_samples(2000, seed)
    with jax_float32_field():
        jf = JNerfactoField(train=train, **FIELD)
        params = init_params(lambda k: jf.init(k, jrs, compute_normals=True), seed)
    rng = np.random.default_rng(seed)
    enc = params["params"]["mlp_base"]["encoding"]
    if train:
        enc["hash_table"] = pair_constant_table(enc["hash_table"].shape, FIELD["base_res"], FIELD["max_res"],
                                                2**FIELD["log2_hashmap_size"], rng)
    tf = float32_field(NerfactoField(device=CPU, **FIELD)).train(train)
    tf.load_state_dict(params_from_jax(params, tf))
    return jf, params, jrs, tf, trs


def _field_loss_weights(n, seed=19):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (n, k)).astype(np.float32) for k in (3, 3, 1)]


@pytest.mark.parametrize("levels", [None, (0, 2)], ids=["all_levels", "P2"])
def test_field_normals_in_training_match_jax(levels):
    """The field's training forward with ``compute_normals`` (K1, its
    position gradient taken with a graph) against JAX's, the MLPs and heads
    in float32 and the hash table constant on the coin's vertex pairs
    (``pair_constant_table``): density, normals and predicted normals within
    1e-4 (float32 sums of another order, through the contraction's
    Jacobian); then the gradients of <normals, a> + <pred normals, b> +
    <density, c> in every parameter (the normals' part a second derivative
    through K1, the MLPs and trunc_exp): each within 1e-3 of its peak; the
    hash table summed per level and feature (the coin picks entries by the
    positions' bits) within 5e-2 of its peak, since JAX sums the table's
    second-order terms in bfloat16 (measured 1.6%; the per-entry bound in
    bfloat16 units is held at the kernel's level,
    ``test_k1_second_derivative_matches_jax``)."""
    jf, params, jrs, tf, trs = _field_pair(True)
    kw = dict(bwd_levels=levels, bwd_scale=1.0 if levels is None else 2.0)
    a, b, c = _field_loss_weights(trs.frustums.origins.shape[0])
    names = jheads.FieldHeadNames

    def jloss(p):
        out = jf.apply(p, jrs, compute_normals=True, **kw)
        val = (jnp.sum(out[names.NORMALS] * a) + jnp.sum(out[names.PRED_NORMALS] * b)
               + jnp.sum(out[names.DENSITY] * c))
        return val, {k.value: v for k, v in out.items()}

    with jax_float32_field():
        (jval, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tf(trs, compute_normals=True, **kw)
    val = ((out[FieldHeadNames.NORMALS] * to_torch(a)).sum() + (out[FieldHeadNames.PRED_NORMALS] * to_torch(b)).sum()
           + (out[FieldHeadNames.DENSITY] * to_torch(c)).sum())
    for key, jkey in ((FieldHeadNames.DENSITY, names.DENSITY), (FieldHeadNames.NORMALS, names.NORMALS),
                      (FieldHeadNames.PRED_NORMALS, names.PRED_NORMALS)):
        ref = np.asarray(jout[jkey.value])
        np.testing.assert_allclose(out[key].detach().numpy(), ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   err_msg=key.value)
    normals = out[FieldHeadNames.NORMALS].detach().numpy()
    assert (np.abs(np.linalg.norm(normals, axis=-1) - 1) < 1e-5).mean() > 0.95  # the dense levels' gradient lives
    val.backward()
    jgrads = params_from_jax(jgrads, tf)
    for n, p in tf.named_parameters():
        ref = jgrads[n].numpy().astype(np.float64)
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy().astype(np.float64)
        rel = 1e-3
        if n.endswith("hash_table"):
            got, ref = (x.reshape(FIELD["num_levels"], -1, 4).sum(axis=1) for x in (got, ref))
            rel = 5e-2
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-9, err_msg=n)


def test_field_normals_in_eval_match_jax():
    """The eval forward (K3, exact) with ``compute_normals`` under
    ``torch.no_grad`` (as ``render_camera`` runs it: the gradient is taken
    locally, in the positions alone, the table a parameter that requires a
    gradient) against JAX's on random tables, the MLPs and heads in float32:
    density, normals and predicted normals within 1e-4; nothing keeps a
    graph; no kernel launched on the CPU."""
    jf, params, jrs, tf, trs = _field_pair(False, seed=23)
    names = jheads.FieldHeadNames
    with jax_float32_field():
        jout = jf.apply(params, jrs, compute_normals=True)
    thg.reset_launch_counts()
    with torch.no_grad():
        out = tf(trs, compute_normals=True)
    assert thg.launch_counts == NO_HASH_LAUNCHES
    for key, jkey in ((FieldHeadNames.DENSITY, names.DENSITY), (FieldHeadNames.NORMALS, names.NORMALS),
                      (FieldHeadNames.PRED_NORMALS, names.PRED_NORMALS)):
        ref = np.asarray(jout[jkey])
        assert not out[key].requires_grad
        np.testing.assert_allclose(out[key].numpy(), ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   err_msg=key.value)
    assert tf.mlp_base.encoding.hash_table.grad is None


def test_zero_density_gradient_gives_zero_normals():
    """Where the density gradient is exactly zero (here every table flat:
    the encoding does not move with the position) the normals are 0 on
    both sides. JAX's gradient through ``jnp.linalg.norm`` there is NaN (0
    times the infinite slope of its sqrt), which reaches every parameter;
    the port's is 0 (torch's norm backward), so its gradients stay finite."""
    from nerfstudio_tpu.fields.nerfacto_field import NerfactoField as JNerfactoField
    from nerfstudio_torch.fields.nerfacto_field import NerfactoField

    jrs, trs = _field_samples(64, 29)
    jf = JNerfactoField(train=True, **FIELD)
    params = init_params(lambda k: jf.init(k, jrs, compute_normals=True), 29)
    enc = params["params"]["mlp_base"]["encoding"]
    enc["hash_table"] = np.ones_like(enc["hash_table"]) * 0.5
    names = jheads.FieldHeadNames
    jn, jg = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jf.apply(p, jrs, compute_normals=True)[names.NORMALS])))(
        params)
    tf = NerfactoField(device=CPU, **FIELD).train()
    tf.load_state_dict(params_from_jax(params, tf))
    out = tf(trs, compute_normals=True)
    assert not out[FieldHeadNames.NORMALS].any() and float(jn) == 0.0
    out[FieldHeadNames.NORMALS].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in tf.parameters() if p.grad is not None)
    assert np.isnan(np.asarray(jg["params"]["mlp_base"]["encoding"]["hash_table"])).any()


HW = 16
RAYS = 64
# the field's levels all dense (resolutions 4, 6, 11, 20 at T=2^14), so the
# pair-constant table keeps the density gradient alive on each; the
# proposal net as TINY_MODEL's
NORMALS_MODEL = dict(TINY_MODEL, log2_hashmap_size=14, max_res=20, predict_normals=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_nerfstudio_fixture(tmp_path_factory.mktemp("normals") / "scene", n=NUM_IMAGES + 1, hw=HW)


def _tables(params, rng):
    """The field's table pair-constant, every proposal table flat."""

    def table(path, x):
        key = jax.tree_util.keystr(path)
        if not key.endswith("['hash_table']"):
            return np.array(x)
        if "proposal_networks" in key:
            L, S, _ = x.shape
            F = 128 * S // 2 ** TINY_MODEL["log2_hashmap_size"]
            return np.ascontiguousarray(np.broadcast_to(
                np.tile(rng.uniform(-1, 1, (L, F)).astype(np.float32), 128 // F)[:, None, :], (L, S, 128)))
        return pair_constant_table(x.shape, NORMALS_MODEL["base_res"], NORMALS_MODEL["max_res"],
                                   2 ** NORMALS_MODEL["log2_hashmap_size"], rng)

    return jax.tree_util.tree_map_with_path(table, params)


@pytest.fixture(scope="module")
def pair(scene):
    """JAX's and the port's factory-built nerfacto with predict_normals on the
    scene, the port's MLPs and heads in float32, at JAX's parameters with
    ``_tables`` and a pose adjustment off zero (its gradient then has a
    second-order part), over one grid (a sphere of occupied cells)."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.pipelines.factory import build_pipeline
    from nerfstudio_torch.utils.convert import occupancy_from_jax
    from test_torch_nerfacto_options import _grid

    parser = dict(data=scene, eval_mode="interval", eval_interval=NUM_IMAGES + 1)
    jconfig = jget_method("nerfacto")
    jconfig.model = dataclasses.replace(jconfig.model, **NORMALS_MODEL)
    jconfig.data, jconfig.dataparser = scene, JNerfstudio(**parser)
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    with jax_float32_field():
        jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    rng = np.random.default_rng(31)
    params = _tables(jax.device_get(jstate.params), rng)
    cam = params["params"]["camera_optimizer"]
    cam["pose_adjustment"] = rng.normal(0, 1e-3, cam["pose_adjustment"].shape).astype(np.float32)
    config = get_method("nerfacto")
    config.data, config.dataparser = scene, NerfstudioDataParserConfig(**parser)
    config.machine.device_type = "cpu"
    config.datamanager.train_num_rays_per_batch = RAYS
    for k, v in NORMALS_MODEL.items():
        setattr(config.model, k, v)
    pipe, state, config = build_pipeline(config)
    float32_field(pipe.model)
    pipe.model.load_state_dict(params_from_jax(params, pipe.model))
    grid = _grid(config.model.occ_grid_resolution)
    state.aux = occupancy_from_jax(grid)
    return jpipe, params, grid, pipe, state, config, jstate


def _jax_step(jpipe, params, aux, key, kwargs):
    from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices

    dm, jmodel = jpipe.datamanager, jpipe.model_train
    k_pix, k_model = jax.random.split(key)
    idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

    def loss_fn(p):
        outputs = jmodel.apply(p, generate_rays_from_indices(dm.train_cameras, idx), key=k_model, model_aux=aux,
                               **kwargs)
        metrics = jmodel.get_metrics_dict(outputs, batch, p)
        loss_dict = jmodel.get_loss_dict(outputs, batch, metrics, p, config=jmodel.config)
        return sum(loss_dict.values()), {**loss_dict, **metrics}

    with jax_float32_field():
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jax.device_get(grads), {"loss": loss, **jax.device_get(metrics)}


@pytest.mark.parametrize("step", [304, 6000, 6001])
def test_normals_step_matches_jax(pair, step):
    """One step with predict_normals, JAX's draws handed in: at 304 (every
    field level's table gradient, the proposal net live) and at 6000 and
    6001 (the two phases of the period-2 level cycle, the proposals frozen).
    The loss and every term within 1e-4 relative (the orientation and
    pred-normal losses among them; measured 1.2e-6 at most), every
    non-table gradient within 1e-3 of its peak (the pose adjustment's too:
    it reaches the normals through the sample positions; measured 1.5e-5 at
    most), each table's gradient summed per level and feature within 2e-2
    of the largest sum (JAX sums the field's second-order table terms and
    the proposal's one-hot rows in bfloat16; measured 6.6e-3)."""
    jpipe, params, grid, pipe, state, config, _ = pair
    model = pipe.model
    model.load_state_dict(params_from_jax(params, model))
    model.zero_grad(set_to_none=True)
    kwargs = type(jpipe.model_train).step_kwargs(step, jpipe.model_train.config)
    assert type(model).step_kwargs(step, config.model) == kwargs
    state.step = step
    key = jax.random.PRNGKey(step)
    jgrads, jmetrics = _jax_step(jpipe, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, grid), key, kwargs)
    jgrads = params_from_jax(jgrads, model)
    n_img, h, w = pipe.datamanager.train_images.shape[:3]
    thg.reset_launch_counts()
    tmetrics = pipe.train_step(state, draws=jax_step_draws(key, RAYS, n_img, h, w), **kwargs)
    assert thg.launch_counts == NO_HASH_LAUNCHES
    for k in ("loss", "rgb_loss", "interlevel_loss", "distortion_loss", "orientation_loss", "pred_normal_loss",
              "camera_opt_regularizer", "psnr"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    assert float(tmetrics["orientation_loss"]) > 0 and float(tmetrics["pred_normal_loss"]) > 0
    for n, p in model.named_parameters():
        ref = jgrads[n].numpy().astype(np.float64)
        assert np.isfinite(ref).all(), n
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy().astype(np.float64)
        if n.endswith("hash_table"):
            F = 128 * got.shape[1] // (2 ** (TINY_MODEL if n.startswith("proposal") else NORMALS_MODEL)[
                "log2_hashmap_size"])
            got, ref = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, ref))
        rel = 2e-2 if n.endswith("hash_table") else 1e-3
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-10, err_msg=n)
    pose = jgrads["camera_optimizer.pose_adjustment"].numpy()
    assert np.abs(pose).max() > 0


def test_eval_chunk_normals_match_jax(pair):
    """One eval chunk (every ray of the first eval view, through the
    pipelines' own eval renders) with predict_normals: the field through K3
    and K3b, the proposal net's table flat (K1 returns the same value
    whichever vertex its rounding picks), the MLPs and heads in float32. rgb,
    accumulation, normals and predicted normals within 1e-4 (float32 sums
    of another order, differentiated once); the normals unit length where
    the accumulation is not negligible; no kernel launched on the CPU."""
    jpipe, params, grid, pipe, state, config, _ = pair
    pipe.model.load_state_dict(params_from_jax(params, pipe.model))
    cam_idx = pipe.datamanager.eval_image(0)[0]
    with jax_float32_field():
        want = jpipe.render_camera(jax.tree_util.tree_map(jnp.asarray, params), jpipe.datamanager.eval_cameras,
                                   cam_idx, HW * HW, aux=jax.tree_util.tree_map(jnp.asarray, grid))
    thg.reset_launch_counts()
    got = pipe.render_eval_camera(state, cam_idx, HW * HW)
    assert thg.launch_counts == NO_HASH_LAUNCHES
    for k in ("rgb", "accumulation", "normals", "pred_normals"):
        assert got[k].shape == (HW, HW, 3 if k != "accumulation" else 1)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)
    seen = got["accumulation"][..., 0] > 1e-3
    assert seen.float().mean() > 0.5
    np.testing.assert_allclose(torch.linalg.norm(got["normals"], dim=-1)[seen].numpy(), 1.0, atol=1e-4)


def test_converted_checkpoint_resumes_and_renders_normals(pair, tmp_path):
    """A JAX nerfacto-with-normals train state after one step at 6000 (live
    Adam moments of the predicted-normal MLP and head) becomes the port's
    checkpoint (``trainer_checkpoint_from_jax``): every parameter, the
    predicted-normal MLP's and head's among them, with their moments.
    Restored into the port it renders the first eval view as JAX does (rgb,
    normals and predicted normals within 1e-4, the MLPs and heads in
    float32)."""
    from nerfstudio_torch.engine import trainer as ttrainer
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    jpipe, params, grid, pipe, state, config, jstate = pair
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate.replace(params=params, aux=grid))
    kwargs = type(jpipe.model_train).step_kwargs(6000, jpipe.model_train.config)
    with jax_float32_field():
        jstate, _ = jpipe.train_step(jstate.replace(step=jnp.asarray(6000, jnp.int32)), jpipe.datamanager.train_images,
                                     jax.random.PRNGKey(4), **kwargs)
    host = jax.device_get(jstate)
    payload = trainer_checkpoint_from_jax(host, pipe.model, state.optimizer)
    names = {k for k, _ in pipe.model.named_parameters()}
    assert set(payload["model"]) == names and payload["step"] == 6001
    assert {"field.mlp_pred_normals.layers.2.weight", "field.field_head_pred_normals.layer.bias"} <= names
    ttrainer.write_checkpoint(tmp_path / "ckpt", 6001, payload)
    ttrainer.restore_train_state(pipe, state, ttrainer.read_checkpoint(tmp_path / "ckpt")[1])
    moments = state.optimizer.state_dict()["optimizers"]["field"]["state"]
    assert len(moments) == sum(1 for k in names if k.startswith("field.")) and all(
        float(v["exp_avg"].abs().max()) > 0 for v in moments.values())
    cam_idx = pipe.datamanager.eval_image(0)[0]
    with jax_float32_field():
        want = jpipe.render_camera(jstate.params, jpipe.datamanager.eval_cameras, cam_idx, HW * HW, aux=jstate.aux)
    got = pipe.render_eval_camera(state, cam_idx, HW * HW)
    for k in ("rgb", "normals", "pred_normals"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)
