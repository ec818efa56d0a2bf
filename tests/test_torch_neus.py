"""neus-facto in the port against the JAX reference: the SDF field's
pieces (NeRF encoding, softplus, weight norm, learned variance), the field
as a whole (values, SDF gradient, alpha, colours), the NeuS compositing
helpers (weights from alphas, sphere collider, normals), the schedules, one
training step at two points of the schedule with JAX's draws handed in,
and a small eval render.

Parameters come from the JAX ``init`` through ``params_from_jax``. The SDF
field runs in float32 on both sides (only the proposal MLPs are bf16), so
most tolerances are float32 ones; the exceptions say why."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, HW, NO_HASH_LAUNCHES, NUM_IMAGES, init_params, jax_step_draws, orbit_c2w, to_torch
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.core.rays import Frustums as JFrustums
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.core.rays import RaySamples as JRaySamples
from nerfstudio_tpu.engine.optimizers import build_optimizers
from nerfstudio_tpu.engine.schedulers import CosineDecaySchedulerConfig as JCosine
from nerfstudio_tpu.engine.schedulers import MultiStepSchedulerConfig as JMultiStep
from nerfstudio_tpu.field_components.encodings import NeRFEncoding as JNeRFEncoding
from nerfstudio_tpu.field_components.field_heads import FieldHeadNames as JNames
from nerfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from nerfstudio_tpu.fields.sdf_field import WNDense as JWNDense
from nerfstudio_tpu.model_components import renderers as jrenderers
from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices as j_rays_from_indices
from nerfstudio_tpu.model_components.scene_colliders import SphereCollider as JSphereCollider
from nerfstudio_tpu.models.base_model import render_camera as j_render_camera
from nerfstudio_tpu.models.neus import NeuSFactoModel as JNeuSFacto
from nerfstudio_tpu.models.neus import NeuSFactoModelConfig as JNeuSFactoConfig
from nerfstudio_tpu.pipelines.base_pipeline import VanillaPipeline as JPipeline
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.core.rays import Frustums, RayBundle, RaySamples
from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
from nerfstudio_torch.engine.optimizers import PerGroupAdam, neus_facto_optimizers
from nerfstudio_torch.engine.schedulers import CosineDecaySchedulerConfig, MultiStepSchedulerConfig
from nerfstudio_torch.field_components.encodings import NeRFEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.fields.sdf_field import LearnedVariance, SDFField, WNDense, softplus100
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.scene_colliders import SphereCollider
from nerfstudio_torch.models.base_model import render_camera
from nerfstudio_torch.models.neus import NeuSFactoModel, NeuSFactoModelConfig
from nerfstudio_torch.ops import hash_grid
from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline
from nerfstudio_torch.utils.convert import params_from_jax, train_state_from_jax

# A small SDF field that keeps the skip (hidden 48 > in_dim 39) and the
# shipped proposal nets (L5 F2 T=2^17, flat layout), at few samples.
TINY_FIELD = dict(num_layers=6, hidden_dim=48, geo_feat_dim=16, num_layers_color=3, hidden_dim_color=24)
TINY_NEUS = dict(TINY_FIELD, num_proposal_samples_per_ray=(24, 12), num_neus_samples_per_ray=8)
RAYS = 48
STEPS = {"early": 300, "steady": 6000}


def _rays_and_samples(n_rays, n_samples, seed):
    """(JAX, torch) RaySamples of rays from a sphere of radius 1.6 towards
    the origin's neighbourhood, samples spread over [0.3, 3.0]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o = 1.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.2, size=(n_rays, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0.3, 3.0, (n_rays, n_samples + 1)), axis=-1).astype(np.float32)
    starts, ends = edges[:, :-1, None], edges[:, 1:, None]
    bo = np.broadcast_to(o[:, None], (n_rays, n_samples, 3)).copy()
    bd = np.broadcast_to(d[:, None], (n_rays, n_samples, 3)).copy()
    area = np.ones((n_rays, n_samples, 1), np.float32)
    jrs = JRaySamples(frustums=JFrustums(origins=bo, directions=bd, starts=starts, ends=ends, pixel_area=area),
                      deltas=ends - starts)
    trs = RaySamples(frustums=Frustums(*(to_torch(x) for x in (bo, bd, starts, ends, area))),
                     deltas=to_torch(ends - starts))
    return jrs, trs


# The NeRF encoding's limit: sin of float32 arguments s = 2 pi x 2^k (+ pi/2)
# with |x| <= 2 and k <= 5, so |s| <= 2 pi * 2 * 32 ~ 402.1 < 512. There a
# float32 ulp of s is 2^-15 (~3.05e-5): an argument rounded one ulp apart
# (another association of 2 pi * x * 2^k, or another rounding of the + pi/2)
# moves sin by up to 2^-15, since |sin'| <= 1. Each side's sin adds at most
# 1 ulp of a result in [-1, 1], 2^-24 each. The two sides agree to ~6e-8
# when their arguments are bit-equal; the limit admits one ulp of argument.
NERF_ENCODING_ATOL = 2.0**-15 + 2 * 2.0**-24


@pytest.mark.parametrize("include_input", [False, True])
def test_nerf_encoding_matches_jax(include_input):
    """sin over [s, s + pi/2], dimension-major: the same float32 ops, within
    one float32 ulp of the argument at |s| <= 402 (NERF_ENCODING_ATOL);
    the appended input exactly."""
    x = np.random.default_rng(0).uniform(-2, 2, (257, 3)).astype(np.float32)
    kw = dict(num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0, include_input=include_input)
    jenc = JNeRFEncoding(in_dim=3, **kw)
    want = np.asarray(jenc.apply({}, jnp.asarray(x)))
    got = NeRFEncoding(3, **kw)(to_torch(x)).numpy()
    assert got.shape == want.shape == (257, NeRFEncoding(3, **kw).get_out_dim())
    sines = 3 * 6 * 2
    # per frequency (over [s, s + pi/2] and the 3 dimensions): which of them
    # drifts, if one does
    per_freq = np.abs(got[:, :sines] - want[:, :sines]).reshape(257, 2, 3, 6).max(axis=(0, 1, 2))
    np.testing.assert_allclose(got[:, :sines], want[:, :sines], rtol=0, atol=NERF_ENCODING_ATOL,
                               err_msg=f"max |port - JAX| per frequency 2^0..2^5: {per_freq.tolist()}")
    np.testing.assert_array_equal(got[:, sines:], want[:, sines:])


def test_softplus_is_exact_logaddexp():
    """The field's beta=100 softplus is ``jax.nn.softplus(100 h) / 100``, an
    exact logaddexp: value and gradient within float32 rounding of JAX's.
    torch's ``softplus(beta=100)`` instead returns h itself once 100 h > 20
    (its threshold), off by log1p(exp(-100 h)) / 100: below float32's
    resolution at h ~ 0.2, so the trap is pinned in float64, where the port
    keeps the exact value (1e-15 relative) and torch's misses by ~2e-11."""
    h = np.concatenate([np.linspace(-1, 1, 401), [0.2001, 0.25, -0.25, 3.0]]).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.nn.softplus(x * 100.0) / 100.0, jnp.asarray(h))
    (want_g,) = vjp(jnp.ones_like(want))
    t = to_torch(h).requires_grad_(True)
    got = softplus100(t)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)
    h64 = torch.tensor([0.2001, 0.205, 0.21], dtype=torch.float64)
    exact = np.logaddexp(100.0 * h64.numpy(), 0.0) / 100.0
    np.testing.assert_allclose(softplus100(h64).numpy(), exact, rtol=1e-15, atol=0)
    thresholded = torch.nn.functional.softplus(h64, beta=100).numpy()
    assert np.all(np.abs(thresholded - exact) > 1e-12)
    # the eikonal loss differentiates twice: finite far below zero, where
    # torch's own logaddexp backward overflows to NaN
    x = torch.tensor([-5.0, -1.0, 0.0, 1.0], requires_grad=True)
    (g,) = torch.autograd.grad(softplus100(x).sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), x)
    assert torch.isfinite(gg).all() and float(g[2].detach()) == 0.5


def test_wndense_clamps_the_norm_as_jax():
    """``W_eff = scale * W / max(||W||, 1e-12)``: a dead (all-zero) output
    unit stays 0 with a finite gradient, where ``torch.nn.utils.weight_norm``
    divides by zero and returns NaN."""
    rng = np.random.default_rng(1)
    kernel = rng.normal(size=(5, 4)).astype(np.float32)
    kernel[:, 2] = 0.0  # one dead column of the (in, out) kernel
    x = rng.normal(size=(7, 5)).astype(np.float32)
    jl = JWNDense(4, kernel_init=lambda *a: jnp.asarray(kernel), bias_init=lambda k, s, d=jnp.float32: jnp.ones(s))
    jp = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jl.apply(jp, jnp.asarray(x)))
    layer = WNDense(5, 4, device=CPU)
    p = jax.device_get(jp)["params"]
    layer.load_state_dict({"weight": to_torch(p["kernel"].T), "scale": to_torch(p["scale"]), "bias": to_torch(p["bias"])})
    got = layer(to_torch(x))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.all(want[:, 2] == 1.0) and torch.isfinite(layer.weight.grad).all()
    wn = torch.nn.utils.weight_norm(torch.nn.Linear(5, 4), dim=0)
    with torch.no_grad():
        wn.weight_v.copy_(to_torch(kernel.T))
    assert torch.isnan(wn(to_torch(x))[:, 2]).all()


def test_learned_variance():
    lv = LearnedVariance(device=CPU)
    assert lv.variance.shape == () and float(lv().detach()) == pytest.approx(float(np.exp(np.float32(0.1) * 10.0)), rel=1e-6)


@pytest.fixture(scope="module")
def field_pair():
    """The JAX SDFField at TINY_FIELD, its init, and the port's field with
    the converted parameters, both in training mode."""
    jfield = JSDFField(num_images=NUM_IMAGES, **TINY_FIELD)
    jrs, _ = _rays_and_samples(4, 3, 0)
    params = jax.device_get(jax.jit(jfield.init)(jax.random.PRNGKey(5), jrs))
    field = SDFField(device=CPU, **TINY_FIELD)
    field.load_state_dict(params_from_jax(params, field))
    return jfield, params, field


def test_sdf_field_layout(field_pair):
    """The skip at layer 4 survives (48 > 39) and the converted tree covers
    every port parameter: weight-normed geometric layers, colour layers and
    the variance."""
    _, params, field = field_pair
    assert field.skips == (4,) and field.in_dim == 39
    names = set(params_from_jax(params, field))
    assert {"glin.0.weight", "glin.0.scale", "glin.0.bias", "clin.2.weight", "deviation_network.variance"} <= names
    assert field.glin[3].weight.shape[0] == 48 - 39 and field.glin[4].weight.shape[1] == 48


@pytest.mark.parametrize("cos_anneal", [0.3, 1.0])
def test_sdf_field_matches_jax(field_pair, cos_anneal):
    """sdf, its gradient (normals), alpha and colours against the JAX
    field's outputs, all float32: sdf and gradient rtol 1e-4 (sum order of
    the 48-wide products and the softplus' exp), alpha and rgb atol 1e-5."""
    jfield, params, field = field_pair
    jrs, trs = _rays_and_samples(32, 16, 1)
    want = jfield.apply(params, jrs, cos_anneal_ratio=cos_anneal)
    got = field(trs, cos_anneal_ratio=cos_anneal)
    for name, tol in ((JNames.SDF, dict(rtol=1e-4, atol=1e-5)), (JNames.GRADIENT, dict(rtol=1e-4, atol=1e-5)),
                      (JNames.NORMALS, dict(rtol=1e-4, atol=1e-5)), (JNames.ALPHA, dict(rtol=0, atol=1e-5)),
                      (JNames.RGB, dict(rtol=0, atol=1e-5))):
        t = got[FieldHeadNames(name.value)].detach().numpy()
        np.testing.assert_allclose(t, np.asarray(want[name]), err_msg=name.value, **tol)


def test_sdf_field_gradients_match_jax(field_pair):
    """The weights' gradient of a loss that uses the rgb and the eikonal
    term (so it differentiates through the SDF gradient: the port must keep
    its graph) against ``jax.grad``: within 1e-4 of each parameter's peak."""
    jfield, params, field = field_pair
    jrs, trs = _rays_and_samples(16, 8, 2)

    def jloss(p):
        out = jfield.apply(p, jrs, cos_anneal_ratio=0.5)
        g = out[JNames.GRADIENT]
        return jnp.mean(out[JNames.RGB] * out[JNames.ALPHA]) + jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    jg = params_from_jax(jax.device_get(jax.grad(jloss)(params)), field)
    field.zero_grad()
    out = field(trs, cos_anneal_ratio=0.5)
    g = out[FieldHeadNames.GRADIENT]
    loss = torch.mean(out[FieldHeadNames.RGB] * out[FieldHeadNames.ALPHA]) + torch.mean(
        (torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    loss.backward()
    for n, p in field.named_parameters():
        ref = jg[n].numpy()
        peak = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=1e-4 * peak, err_msg=n)
    # the eikonal term alone reaches the first layer's xyz weights only through the SDF gradient
    field.zero_grad()
    out = field(trs)
    torch.mean((torch.linalg.norm(out[FieldHeadNames.GRADIENT], dim=-1) - 1.0) ** 2).backward()
    assert field.glin[0].weight.grad[:, :3].abs().max() > 0


def test_port_init_is_a_sphere_sdf():
    """The port's own init (``reset_parameters``, which chip_smoke.py trains
    from) at full width: the SAL sphere of radius 0.8, as the reference's
    (tests/models/test_sdf_field.py): sdf correlates with |x| - 0.8 above
    0.9 with an rms gap below 0.35, and the eikonal residual is below 0.1."""
    field = SDFField(device=CPU)
    field.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.rand((2048, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    p = x.clone().requires_grad_(True)
    sdf = field.forward_geonetwork(p)[:, 0]
    (g,) = torch.autograd.grad(sdf.sum(), p)
    target = torch.linalg.norm(x, dim=-1) - 0.8
    sdf = sdf.detach()
    assert float(torch.corrcoef(torch.stack([sdf, target]))[0, 1]) > 0.9
    assert float(torch.sqrt(torch.mean((sdf - target) ** 2))) < 0.35
    assert float(torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)) < 0.1


def test_sdf_field_eval_has_normals_without_a_graph(field_pair):
    """Under no_grad (the eval render) the field still takes the SDF
    gradient, and returns tensors without a graph."""
    _, _, field = field_pair
    _, trs = _rays_and_samples(8, 4, 3)
    with torch.no_grad():
        out = field(trs)
    ref = field(trs)
    for k, v in out.items():
        assert v.grad_fn is None, k
        torch.testing.assert_close(v, ref[k].detach(), rtol=0, atol=0)


def test_weights_from_alphas_match_jax():
    """log-space exclusive cumprod with 1 - alpha clipped to [1e-10, 1];
    alphas include 0 and 1 (rtol 1e-6). The gradient at alpha = 0 follows
    jnp.clip's 1/2 at the bound."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (9, 20, 1)).astype(np.float32)
    a[0, :3, 0] = [0.0, 1.0, 0.5]
    a[1, :, 0] = 0.0
    (jw, jt), vjp = jax.vjp(JRaySamples.get_weights_and_transmittance_from_alphas, jnp.asarray(a))
    g = rng.normal(size=a.shape).astype(np.float32)
    (ja,) = vjp((jnp.asarray(g), jnp.zeros_like(jt)))
    t = to_torch(a).requires_grad_(True)
    w, tr = RaySamples.get_weights_and_transmittance_from_alphas(t)
    w.backward(to_torch(g))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("training", [True, False])
def test_sphere_collider_matches_jax(training):
    """Rays that hit, graze and miss the unit sphere, from outside and
    inside: nears and fars within float32 rounding."""
    rng = np.random.default_rng(5)
    o = rng.uniform(-2.5, 2.5, (200, 3)).astype(np.float32)
    o[:3] = [[0, 0, 0], [0.2, 0.1, 0], [3, 0, 0]]
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    area = np.ones((200, 1), np.float32)
    col = dict(radius=1.0, near_plane=0.05)
    jrb = JSphereCollider(center=jnp.zeros(3), **col)(JRayBundle(origins=o, directions=d, pixel_area=area),
                                                    training=training)
    trb = SphereCollider((0.0, 0.0, 0.0), **col)(RayBundle(to_torch(o), to_torch(d), to_torch(area)),
                                                  training=training)
    np.testing.assert_allclose(trb.nears.numpy(), np.asarray(jrb.nears), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(trb.fars.numpy(), np.asarray(jrb.fars), rtol=1e-5, atol=1e-6)


def test_render_normals_match_jax():
    rng = np.random.default_rng(6)
    n = rng.normal(size=(11, 7, 3)).astype(np.float32)
    w = rng.uniform(size=(11, 7, 1)).astype(np.float32)
    w[0] = 0.0  # a ray with no weight: the 1e-10 floor keeps it finite
    want = np.asarray(jrenderers.render_normals(jnp.asarray(n), jnp.asarray(w)))
    got = renderers.render_normals(to_torch(n), to_torch(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "port, ref",
    [
        (CosineDecaySchedulerConfig(warm_up_end=500, max_steps=20000), JCosine(warm_up_end=500, max_steps=20000)),
        (MultiStepSchedulerConfig(), JMultiStep(max_steps=20000)),
        (MultiStepSchedulerConfig(milestones=(10, 20)), JMultiStep(milestones=(10, 20))),
    ],
)
def test_schedules_match_jax(port, ref):
    """The optax schedules at counts across warm-up, decay and milestones
    (rtol 1e-6: both evaluate in float32)."""
    lr = 5e-4
    fp, fj = port.build(lr), ref.build(lr)
    for count in (0, 1, 9, 10, 11, 20, 250, 499, 500, 501, 6000, 19999, 20000, 25000):
        assert fp(count) == pytest.approx(float(fj(count)), rel=1e-6, abs=1e-12), count


# --------------------------------------------------------------------------
# the training step and the eval render


@pytest.fixture(scope="module")
def world():
    """The JAX side (bench.py's synthetic scene, the tiny neus-facto, its
    init, its pipeline and a jitted loss-and-gradient of its train step)
    and the port's data manager."""
    from __graft_entry__ import _synthetic_setup

    _, dm, _, _ = _synthetic_setup(hw=HW, n_images=NUM_IMAGES, rays=RAYS, tiny=True)
    jcfg = dataclasses.replace(JNeuSFactoConfig(eval_num_rays_per_chunk=64), **TINY_NEUS)
    jmodel = JNeuSFacto(config=jcfg, num_train_data=NUM_IMAGES, train=True)
    idx, _ = dm.sample_train_batch(jax.random.PRNGKey(0), dm.train_images, num_rays=8)
    params = init_params(
        lambda k: jmodel.init(k, j_rays_from_indices(dm.train_cameras, idx), key=jax.random.PRNGKey(0)), 31
    )
    jpipe = JPipeline(dm, jmodel, None, tx=build_optimizers(_jax_optimizers(), params))

    def loss_and_grads(params, key, cosine_anneal):
        k_pix, k_model = jax.random.split(key)
        idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

        def loss_fn(p):
            rb = j_rays_from_indices(dm.train_cameras, idx)
            outputs = jmodel.apply(p, rb, key=k_model, cosine_anneal=cosine_anneal)
            loss_dict = jmodel.get_loss_dict(outputs, batch, None, p, config=jmodel.config)
            return sum(loss_dict.values()), loss_dict

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    tcams = Cameras.create(np.array(dm.train_cameras.camera_to_worlds), HW * 1.2, HW * 1.2, HW / 2, HW / 2, HW, HW,
                           device=CPU)
    tdm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=RAYS), tcams,
                                 torch.from_numpy(np.array(dm.train_images)), device=CPU)
    return dict(jmodel=jmodel, jcfg=jcfg, params=params, jpipe=jpipe, dm=dm, tdm=tdm,
                loss_and_grads=jax.jit(loss_and_grads))


def _jax_optimizers():
    from nerfstudio_tpu.configs.method_configs import get_method

    return get_method("neus-facto").optimizers


def _torch_model(train: bool):
    cfg = NeuSFactoModelConfig(eval_num_rays_per_chunk=64, **TINY_NEUS)
    return cfg.setup(num_train_data=NUM_IMAGES, device=CPU).train(train)


def _run(world, start):
    """Two steps (start, start+1) on both sides from the same params."""
    jmodel, jcfg, jpipe, dm, tdm = (world[k] for k in ("jmodel", "jcfg", "jpipe", "dm", "tdm"))
    jstate = jpipe.init_state(jax.random.PRNGKey(0), params=world["params"])
    model = _torch_model(train=True)
    state_dict, aux, _ = train_state_from_jax(jstate, model)
    assert aux is None
    model.load_state_dict(state_dict)
    tstate = TrainState(PerGroupAdam(neus_facto_optimizers(), model), step=start)
    tpipe = VanillaPipeline(tdm, model)
    records = []
    for i, step in enumerate(range(start, start + 2)):
        k_step = jax.random.PRNGKey(200 + i)
        kwargs = JNeuSFacto.step_kwargs(step, jcfg)
        assert NeuSFactoModel.step_kwargs(step, model.config) == kwargs
        rec = dict(step=step, kwargs=kwargs)
        if i == 0:
            (_, rec["j_terms"]), rec["j_grads"] = world["loss_and_grads"](jstate.params, k_step,
                                                                          kwargs["cosine_anneal"])
        hash_grid.reset_launch_counts()
        jstate, jmetrics = jpipe.train_step(jstate, dm.train_images, k_step, **kwargs)
        tstate.step = step
        tmetrics = tpipe.train_step(tstate, draws=jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW, n_rounds=3),
                                    **kwargs)
        rec["launches"] = dict(hash_grid.launch_counts)
        rec["j_metrics"] = {k: float(v) for k, v in jmetrics.items()}
        rec["t_metrics"] = {k: float(v) for k, v in tmetrics.items()}
        if i == 0:
            rec["t_grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        records.append(rec)
    return records, jax.device_get(jstate.params), model


@pytest.fixture(scope="module", params=list(STEPS))
def run(request, world):
    return (request.param,) + _run(world, STEPS[request.param])


def test_step_kwargs_and_kernel_paths(run):
    """The cos anneal follows the step (asserted equal to the reference's
    inside the run); on the CPU the proposal nets' K7 calls take the twin,
    so no launch is counted."""
    name, records, _, _ = run
    assert records[0]["kwargs"]["cosine_anneal"] == pytest.approx(STEPS[name] / 20000 if name == "early" else 0.3)
    for rec in records:
        assert rec["launches"] == NO_HASH_LAUNCHES


def test_losses_match_jax(run):
    """Loss terms and PSNR at both steps. K7 is exact and the SDF field
    float32, so the forwards differ by the proposal MLPs' bf16 products
    rounded in another order, which move the proposal and NeuS samples by
    float32 ulps: rgb, eikonal, loss and psnr rtol 1e-3, the interlevel
    term (a small difference of histograms) 2e-2."""
    _, records, _, _ = run
    rtol = dict(loss=1e-3, rgb_loss=1e-3, eikonal_loss=1e-3, psnr=1e-3, interlevel_loss=2e-2)
    for rec in records:
        j, t = rec["j_metrics"], rec["t_metrics"]
        assert set(rtol) == set(t) == set(j), (sorted(t), sorted(j))
        for k, r in rtol.items():
            np.testing.assert_allclose(t[k], j[k], rtol=r, atol=1e-8, err_msg=f"step {rec['step']} {k}")


def test_first_step_gradients_match_jax(run):
    """The first step's gradients at identical parameters, each within a
    share of its parameter's peak: the SDF field's 1e-4 (measured <= 4e-5),
    but 1e-2 for the two layers that read the positional encoding (measured
    3.0e-3: the eikonal term's second derivative carries the top
    frequency's (2 pi 32)^2, which amplifies the samples' float32-ulp
    differences); the proposal nets' (bf16 MLPs, flat tables) 5e-2
    (measured 1.6e-2)."""
    _, records, _, model = run
    rec = records[0]
    jg = params_from_jax(rec["j_grads"], model)
    pe_fed = {f"field.glin.{i}.weight" for i in (0,) + model.field.skips}
    for n, ref in jg.items():
        ref = ref.numpy()
        got = rec["t_grads"][n].numpy()
        rel = 5e-2 if n.startswith("proposal_networks") else 1e-2 if n in pe_fed else 1e-4
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=n)


def test_parameters_after_two_adam_steps(run):
    """Parameters after the two steps, in units of each group's learning
    rate (the field's warm-up gives it 0, then 1e-6; the proposal nets
    1e-2). Adam's first steps move every entry with a gradient by about the
    rate whatever its size, so an entry whose gradient is near zero lifts
    the two sides' rounding differences to a large part of a step, and a
    table entry that only one side's samples reached takes its whole step
    alone: at most 2 rates per entry (measured 1.49, one proposal-table
    entry at step 6000; 0.28 elsewhere) and a mean of 0.02 per tensor
    (measured 0.0032)."""
    _, _, jparams, model = run
    jp = params_from_jax(jparams, model)
    for n, p in model.named_parameters():
        lr = 1e-6 if n.startswith("field") else 1e-2
        gap = np.abs(p.detach().numpy() - jp[n].numpy()) / lr
        assert gap.max() <= 2.0 and gap.mean() <= 0.02, (n, gap.max(), gap.mean())


def test_eval_render_matches_jax(world):
    """A 16x16 eval render in 64-ray chunks from the JAX init: rgb,
    accumulation, expected depth and normals (rtol/atol 1e-3: the proposal
    MLPs' bf16 products move the NeuS samples by float32 ulps)."""
    jmodel, jcfg, params = world["jmodel"], world["jcfg"], world["params"]
    jeval = JNeuSFacto(config=jcfg, num_train_data=NUM_IMAGES, train=False)
    c2w = orbit_c2w(2)
    jcams = JCameras(camera_to_worlds=c2w, fx=16.0, fy=16.0, cx=8.0, cy=8.0, width=16, height=16)
    want = j_render_camera(jax.jit(lambda rb: jeval.apply(params, rb)), jcams, 1, 64)
    model = _torch_model(train=False)
    model.load_state_dict(params_from_jax(params, model))
    got = render_camera(model, None, Cameras.create(c2w, 16.0, 16.0, 8.0, 8.0, 16, 16, device=CPU), 1, 64)
    assert set(got) == {"rgb", "accumulation", "depth", "normals"}
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3, atol=1e-3, err_msg=k)


def test_optimizer_groups_and_rates():
    """neus-facto's two groups: the field and both proposal nets, with the
    reference's rates at the first counts (the field's warm-up starts at 0)."""
    model = _torch_model(train=True)
    opt = PerGroupAdam(neus_facto_optimizers(), model)
    assert set(opt.optimizers) == {"field", "proposal_networks"}
    n_prop = sum(p.numel() for p in model.proposal_networks.parameters())
    assert sum(p.numel() for g in opt.optimizers["proposal_networks"].param_groups for p in g["params"]) == n_prop
    assert opt.learning_rates() == {"field": 0.0, "proposal_networks": pytest.approx(1e-2)}
