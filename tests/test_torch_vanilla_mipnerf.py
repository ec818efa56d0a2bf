"""vanilla-nerf and mip-NeRF in the port against the JAX reference: the MLP
with skips, mip-NeRF's conical-frustum Gaussians, ``expected_sin`` and the
integrated ``NeRFEncoding`` at 16 frequencies, one training step of each
method (loss terms and gradients), the eval forward, RAdam against
``optax.radam`` on both sides of rho_t = 5, and the method configs.

Small sizes: the NeRF field at 6 layers x 32 with the skip at 4 (a hidden
layer: JAX ignores a skip at the output layer, as a 5-layer net's 4 would
be) and a 2 x 16 head, 64 rays of 8 + 8 samples. Inputs are drawn with numpy from a seed;
JAX's parameters reach the port through ``params_from_jax``, JAX's jitter
draws are handed in."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, to_torch
import nerfstudio_tpu.fields.vanilla_nerf_field as jnerf_field
import nerfstudio_tpu.models.mipnerf as jmipnerf
import nerfstudio_tpu.models.vanilla_nerf as jvanilla
from nerfstudio_tpu.configs.method_configs import get_method as jget_method
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.engine.optimizers import build_optimizers
from nerfstudio_tpu.field_components import encodings as jenc
from nerfstudio_tpu.field_components import field_heads as jheads
from nerfstudio_tpu.field_components import mlp as jmlp
from nerfstudio_tpu.utils import math as jmath
import nerfstudio_torch.models.mipnerf as tmipnerf
import nerfstudio_torch.models.vanilla_nerf as tvanilla
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.core.rays import Frustums, RayBundle
from nerfstudio_torch.engine.optimizers import PerGroupAdam, RAdam
from nerfstudio_torch.field_components.encodings import NeRFEncoding
from nerfstudio_torch.field_components.field_heads import FieldHead
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
from nerfstudio_torch.utils import math as tmath
from nerfstudio_torch.utils.convert import params_from_jax

RAYS = 64
TINY_FIELD = dict(base_mlp_num_layers=6, base_mlp_layer_width=32, head_mlp_layer_width=16)
TINY_SAMPLES = dict(num_coarse_samples=8, num_importance_samples=8)


def _ulp(x):
    """The float32 spacing at |x|."""
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


# --------------------------------------------------------------------------
# the MLP with skips


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_with_skips_matches_jax(dtype):
    """5 layers x 32 with skips at 2 and 4: layer 2 reads ``cat([h, x0])``,
    the output layer (4) never does, as in JAX's loop over the hidden
    layers alone. The same
    layer widths and names as JAX's, outputs and input gradients within
    1e-5 of their peak in float32, 2e-2 in bfloat16 (a few bfloat16
    roundings of the products, taken in another order)."""
    kw = dict(in_dim=10, num_layers=5, layer_width=32, out_dim=3, skip_connections=(2, 4), out_activation="sigmoid")
    jm = jmlp.MLP(**kw, dtype=getattr(jnp, dtype))
    x = np.random.default_rng(0).normal(size=(200, 10)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = MLP(**kw, device=CPU)
    tm.dtype = getattr(torch, dtype)
    tm.load_state_dict(params_from_jax(params, tm))
    assert [tuple(layer.weight.shape) for layer in tm.layers] == [(32, 10), (32, 32), (32, 42), (32, 32), (3, 32)]
    want, pull = jax.vjp(lambda v: jm.apply(params, v), jnp.asarray(x))
    tx = to_torch(x).requires_grad_(True)
    got = tm(tx)
    rel = 2e-2 if dtype == "bfloat16" else 1e-5
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= rel * np.abs(want).max()
    got.sum().backward()
    (jg,) = pull(jnp.ones_like(want))
    assert np.abs(tx.grad.numpy() - np.asarray(jg)).max() <= rel * np.abs(jg).max()
    with pytest.raises(ValueError, match="layer 0"):
        MLP(in_dim=3, num_layers=3, layer_width=8, skip_connections=(0,), device=CPU)


# --------------------------------------------------------------------------
# mip-NeRF's Gaussians and the integrated encoding


def _frustums(seed, rays=RAYS, samples=16):
    """Frustums (origins, directions, starts, ends, pixel areas) of rays from
    radius 4 towards the middle, edges sorted in [2, 6]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.3, size=(rays, 1, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(2, 6, (rays, samples + 1)), axis=-1).astype(np.float32)
    area = rng.uniform(1e-5, 1e-3, (rays, 1, 1)).astype(np.float32)
    shape = (rays, samples)
    return (np.broadcast_to(o, shape + (3,)).copy(), np.broadcast_to(d, shape + (3,)).copy(), t[:, :-1, None],
            t[:, 1:, None], np.broadcast_to(area, shape + (1,)).copy())


def test_conical_frustum_gaussians_match_jax():
    """``Frustums.get_gaussian_blob`` (radius sqrt(area / pi)) against JAX's:
    means bit-equal (the same float32 steps in the same order), covariances
    within 1e-7 of their peak (the outer products' one rounding)."""
    from nerfstudio_tpu.core.rays import Frustums as JFrustums

    o, d, s, e, a = _frustums(1)
    want = JFrustums(origins=o, directions=d, starts=s, ends=e, pixel_area=a).get_gaussian_blob()
    got = Frustums(*map(to_torch, (o, d, s, e, a))).get_gaussian_blob()
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
    cov = np.asarray(want.cov)
    assert got.cov.shape == cov.shape == (RAYS, 16, 3, 3)
    assert np.abs(got.cov.numpy() - cov).max() <= 1e-7 * np.abs(cov).max()


def test_expected_sin_matches_jax():
    """exp(-var / 2) sin(mean) within 1e-6: one exp and one sin, float32."""
    rng = np.random.default_rng(2)
    m, v = rng.normal(scale=20, size=(2, 1000)).astype(np.float32)
    v = np.abs(v)
    want = np.asarray(jmath.expected_sin(jnp.asarray(m), jnp.asarray(v)))
    np.testing.assert_allclose(tmath.expected_sin(to_torch(m), to_torch(v)).numpy(), want, rtol=0, atol=1e-6)


def test_integrated_encoding_at_16_frequencies_matches_jax():
    """mip-NeRF's position encoding (16 frequencies 2^(14 i / 15), the input
    appended) of the frustums' Gaussians. The exponents come from a
    linspace bit-equal to JAX's, but ``2.0 ** e`` rounds to the nearest
    float32 in PyTorch while XLA's float32 pow lands up to 6 ulps off it
    (at 7 of the 16 exponents, which are not integers). Each damped sine is
    held within exp(-var / 2) times 8 float32 ulps of its argument 2 pi x f
    (those 6, and the two roundings of the argument), plus 1e-6: at the top
    frequency, 2^14 x 2 pi x 4, one ulp is 0.03 rad, where the damping
    leaves nothing; where the damping leaves the sine alive an ulp of the
    argument is at most ~1e-4. The damping itself takes the variance's
    ulps (f^2): within var times 2^-19 relative. The means' and
    covariances' gradients within 1e-3 of their peak (measured 1.7e-4: the
    cosines carry the same ulps of their arguments, weighted by 2 pi f)."""
    o, d, s, e, a = _frustums(3)
    g = Frustums(*map(to_torch, (o, d, s, e, a))).get_gaussian_blob()
    mean, cov = g.mean.numpy(), g.cov.numpy()
    jm = jenc.NeRFEncoding(in_dim=3, num_frequencies=16, min_freq_exp=0.0, max_freq_exp=14.0, include_input=True)

    def jfn(m, c):
        return jm.apply({}, m, c)

    want, pull = jax.vjp(jfn, jnp.asarray(mean), jnp.asarray(cov))
    want = np.asarray(want)
    enc = NeRFEncoding(3, 16, 0.0, 14.0, include_input=True)
    tm, tc = to_torch(mean).requires_grad_(True), to_torch(cov).requires_grad_(True)
    got = enc(tm, tc)
    assert got.shape == want.shape == (RAYS, 16, enc.get_out_dim()) and enc.get_out_dim() == 99
    freqs = (2.0 ** np.linspace(0.0, 14.0, 16)).astype(np.float64)
    arg = (2 * np.pi * mean.astype(np.float64))[..., None] * freqs  # (R, S, 3, 16)
    var = (2 * np.pi) ** 2 * np.diagonal(cov, axis1=-2, axis2=-1).astype(np.float64)[..., None] * freqs**2
    damp = np.exp(-0.5 * var).reshape(RAYS, 16, -1)
    err = damp * (8 * _ulp(arg) + var * 2.0**-19).reshape(RAYS, 16, -1)
    tol = np.concatenate([err, err, np.zeros_like(mean)], axis=-1) + 1e-6
    np.testing.assert_array_less(np.abs(got.detach().numpy() - want), tol)
    cot = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)
    got.backward(to_torch(cot))
    for gt, gj in zip((tm.grad, tc.grad), pull(jnp.asarray(cot))):
        gj = np.asarray(gj)
        assert np.abs(gt.numpy() - gj).max() <= 1e-3 * np.abs(gj).max()


# --------------------------------------------------------------------------
# one training step and the eval forward


def _rays(seed, n=RAYS):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.3, size=(n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full((n, 1), 1e-4, np.float32)


METHODS = {"vanilla-nerf": (jvanilla, tvanilla, "NeRFModel", "VanillaModelConfig"),
           "mipnerf": (jmipnerf, tmipnerf, "MipNerfModel", "MipNerfModelConfig")}


def _jax_model(method, train, float32, monkeypatch):
    """JAX's model at TINY_FIELD and TINY_SAMPLES; with ``float32`` its MLPs
    and heads compute in float32."""
    jmod, _, name, cfg_name = METHODS[method]
    if float32:
        f32 = dict(dtype=jnp.float32)
        monkeypatch.setattr(jnerf_field, "MLP", functools.partial(jmlp.MLP, **f32))
        monkeypatch.setattr(jnerf_field, "DensityFieldHead", functools.partial(jheads.DensityFieldHead, **f32))
        monkeypatch.setattr(jnerf_field, "RGBFieldHead", functools.partial(jheads.RGBFieldHead, **f32))
    monkeypatch.setattr(jmod, "NeRFField", functools.partial(jnerf_field.NeRFField, **TINY_FIELD))
    cfg = dataclasses.replace(jget_method(method).model, **TINY_SAMPLES)
    return getattr(jmod, name)(config=cfg, num_train_data=4, train=train), cfg


def _torch_model(method, params, train, float32, monkeypatch):
    _, tmod, _, cfg_name = METHODS[method]
    monkeypatch.setattr(tmod, "NeRFField", functools.partial(NeRFField, **TINY_FIELD))
    cfg = dataclasses.replace(get_method(method).model, **TINY_SAMPLES)
    model = cfg.setup(num_train_data=4, device=CPU).train(train)
    assert type(cfg).__name__ == cfg_name
    model.load_state_dict(params_from_jax(params, model))
    if float32:
        for m in model.modules():
            if isinstance(m, (MLP, FieldHead)):
                m.dtype = torch.float32
    return model


@pytest.mark.parametrize("float32", [False, True])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_training_step_matches_jax(method, float32, monkeypatch):
    """One step's loss terms (each pass's rgb MSE over white) and gradients
    from JAX's init, the same rays, an RGBA ground truth (transparent,
    opaque and partial pixels) and JAX's jitter draws (nine per ray and
    sampler). With every MLP and head in float32: loss terms within 1e-5
    relative, every gradient within 1e-3 of its peak (mip-NeRF's integrated
    encoding carries the frequencies' ulps, test above). As shipped, in
    bfloat16: loss terms within 2e-3 and the weights' gradients within 5e-2
    of their peak; the bias gradients land up to ~8% off JAX's (sums of
    bfloat16 cotangents in another order) and are held in float32 only, as
    the nerfacto-family step tests hold theirs."""
    jmodel, jcfg = _jax_model(method, True, float32, monkeypatch)
    o, d, a = _rays(1)
    gt = np.random.default_rng(2).uniform(size=(RAYS, 4)).astype(np.float32)
    gt[:16, 3], gt[16:32, 3] = 0.0, 1.0
    key = jax.random.PRNGKey(5)
    jrb = JRayBundle(origins=o, directions=d, pixel_area=a)
    params = jax.device_get(jax.jit(lambda k: jmodel.init(k, jrb, key=k))(jax.random.PRNGKey(0)))

    def loss_fn(p):
        out = jmodel.apply(p, jrb, key=key)
        terms = jmodel.get_loss_dict(out, {"image": jnp.asarray(gt)}, None, p)
        return sum(terms.values()), terms

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    k1, k2, _ = jax.random.split(key, 3)
    n = TINY_SAMPLES["num_coarse_samples"] + 1
    draws = SamplerUniforms(None, (to_torch(jax.random.uniform(k1, (RAYS, n))),
                                   to_torch(jax.random.uniform(k2, (RAYS, TINY_SAMPLES["num_importance_samples"] + 1)))))
    model = _torch_model(method, params, True, float32, monkeypatch)
    out = model(RayBundle(to_torch(o), to_torch(d), to_torch(a)), uniforms=draws)
    terms = model.get_loss_dict(out, {"image": to_torch(gt)})
    assert set(terms) == set(jterms) == {"rgb_loss_coarse", "rgb_loss_fine"}
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=1e-5 if float32 else 2e-3, err_msg=k)
    sum(terms.values()).backward()
    jg = params_from_jax(jax.device_get(jgrads), model)
    assert set(jg) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        if n.endswith(".bias") and not float32:
            continue
        ref = jg[n].numpy()
        rel = 1e-3 if float32 else 5e-2
        assert np.abs(p.grad.numpy() - ref).max() <= rel * np.abs(ref).max(), n


@pytest.mark.parametrize("method", sorted(METHODS))
def test_eval_forward_matches_jax(method, monkeypatch):
    """The eval forward (midpoint samples, the eval near plane) in float32:
    every output within 1e-4 of JAX's (depths within 1e-4 relative)."""
    jmodel, _ = _jax_model(method, False, True, monkeypatch)
    o, d, a = _rays(3)
    jrb = JRayBundle(origins=o, directions=d, pixel_area=a)
    params = jax.device_get(jax.jit(lambda k: jmodel.init(k, jrb))(jax.random.PRNGKey(1)))
    want = jax.jit(lambda p: jmodel.apply(p, jrb))(params)
    model = _torch_model(method, params, False, True, monkeypatch)
    with torch.no_grad():
        got = model(RayBundle(to_torch(o), to_torch(d), to_torch(a)))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_mipnerf_shares_one_field_and_dnerf_is_refused():
    """mip-NeRF's coarse and fine passes read one field (16 position
    frequencies, integrated); vanilla-nerf has two and no temporal
    distortion; with ``enable_temporal_distortion`` (dnerf, no longer
    refused) the model adds D-NeRF's deformation net (84 features, 4 x 256,
    out 3), whose parameters form the ``temporal_distortion`` group."""
    mip = get_method("mipnerf").model.setup(device=CPU)
    assert mip.fields()[0] is mip.fields()[1] and mip.field.use_integrated_encoding
    assert mip.field.position_encoding.get_out_dim() == 99
    assert {n.split(".")[0] for n, _ in mip.named_parameters()} == {"field"}
    nerf = get_method("vanilla-nerf").model.setup(device=CPU)
    assert nerf.field_coarse is not nerf.field_fine
    assert nerf.field_coarse.mlp_base.layers[4].in_features == 256 + 63
    assert not hasattr(nerf, "temporal_distortion")
    dnerf = dataclasses.replace(get_method("vanilla-nerf").model, enable_temporal_distortion=True).setup(device=CPU)
    assert [layer.in_features for layer in dnerf.temporal_distortion.mlp.layers] == [84, 256, 256, 256]
    assert dnerf.temporal_distortion.mlp.layers[-1].out_features == 3
    assert {n.split(".")[0] for n, _ in dnerf.named_parameters()} == {"field_coarse", "field_fine",
                                                                        "temporal_distortion"}


# --------------------------------------------------------------------------
# RAdam


class _Params(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.field = torch.nn.Module()
        for k, v in tree.items():
            self.field.register_parameter(k, torch.nn.Parameter(to_torch(v)))


def test_radam_matches_optax_on_both_sides_of_the_threshold():
    """mipnerf's group (RAdam at 5e-4, eps 1e-8, no schedule) against
    ``optax.radam`` through JAX's ``build_optimizers``, 8 steps with the
    same gradients, the 4th all zero: rho_t stays under 5 for steps 1-5
    (the update is the bias-corrected first moment) and passes it at 6
    (rectified). After step t the parameters within t float32 ulps of
    JAX's jitted update (each side rounds p + u once a step; measured
    bit-equal), the moments within 1e-6 relative."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    jparams = {"params": {"field": {k: jnp.asarray(v) for k, v in tree.items()}}}
    tx = build_optimizers(jget_method("mipnerf").optimizers, jparams)
    opt_state, update = tx.init(jparams), jax.jit(tx.update)
    module = _Params(tree)
    opt = PerGroupAdam(get_method("mipnerf").optimizers, module)
    assert isinstance(opt.optimizers["field"], RAdam)
    rectified = []
    for step in range(1, 9):
        grads = {k: (np.zeros_like(v) if step == 4 else rng.normal(size=v.shape).astype(np.float32))
                 for k, v in tree.items()}
        updates, opt_state = update({"params": {"field": grads}}, opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.zero_grad()
        for k, p in module.field.named_parameters():
            p.grad = to_torch(grads[k])
        assert opt.learning_rates() == {"field": 5e-4}
        opt.step()
        rectified.append(RAdam.scalars(step, 0.9, 0.999)[2] is not None)
        for k, p in module.field.named_parameters():
            want = np.asarray(jparams["params"]["field"][k])
            assert np.all(np.abs(p.detach().numpy() - want) <= step * np.spacing(np.abs(want))), (step, k)
    assert rectified == [False] * 5 + [True] * 3
    (adam,) = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu"))[:1]
    assert int(adam.count) == 8 == opt.optimizers["field"].state[module.field.a]["step"]
    for k, p in module.field.named_parameters():
        st = opt.optimizers["field"].state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu["params"]["field"][k]), rtol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu["params"]["field"][k]), rtol=1e-6)


def test_vanilla_nerf_optimizer_takes_the_empty_temporal_group():
    """vanilla-nerf ships a ``temporal_distortion`` RAdam group that no
    parameter joins without the distortion: the optimizer steps the field
    alone, its state dict round-trips."""
    model = get_method("vanilla-nerf").model.setup(device=CPU)
    opt = PerGroupAdam(get_method("vanilla-nerf").optimizers, model)
    assert set(opt.optimizers) == {"field"} and isinstance(opt.optimizers["field"], RAdam)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.state_dict()
    again = PerGroupAdam(get_method("vanilla-nerf").optimizers, model)
    again.load_state_dict(state)
    assert again.count == 1 and again.state_dict()["optimizers"]["field"]["state"][0]["step"] == 1


# --------------------------------------------------------------------------
# the method configs


@pytest.mark.parametrize("method", ["tensorf", "vanilla-nerf", "mipnerf"])
def test_method_config_matches_jax(method):
    """``get_method`` returns the shipped config: every field the two share
    equal (the model's every field), the trainer, datamanager and
    dataparser with exactly JAX's fields, and each optimizer group's kind,
    rate, eps, betas and schedule (or none) equal."""
    from test_torch_cli import _leaves

    jcfg, tcfg = jget_method(method), get_method(method)
    j, t = _leaves(jcfg), _leaves(tcfg)
    assert {k for k in j if k.startswith("model.")} == {k for k in t if k.startswith("model.")}
    shared = set(j) & set(t)
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    for part in ("trainer.", "datamanager.", "dataparser."):
        assert {k for k in t if k.startswith(part)} == {k for k in j if k.startswith(part)}, part
    assert set(tcfg.optimizers) == set(jcfg.optimizers)
    for g, jo in jcfg.optimizers.items():
        to = tcfg.optimizers[g]
        assert type(to["optimizer"]).__name__ == type(jo["optimizer"]).__name__, g
        for f in ("lr", "eps", "betas"):
            assert getattr(to["optimizer"], f) == getattr(jo["optimizer"], f), (g, f)
        js, ts = jo["scheduler"], to["scheduler"]
        assert type(ts).__name__ == type(js).__name__, g
        if js is not None:
            assert dataclasses.asdict(ts) == {k: getattr(js, k) for k in dataclasses.asdict(ts)}, g
