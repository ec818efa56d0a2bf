"""TensoRF in the port against the JAX reference: the three tensor
encodings and ``tv_loss`` (values and gradients), ``AABBBoxCollider`` and
``intersect_aabb`` (rays that miss, rays parallel to a face), one training
step (every loss term and every gradient), an eval chunk under the
background override, and the upsample hook (the grids resampled as
``jax.image.resize`` does, the optimizer re-initialised: counts, rate and
the next update equal to a fresh optax state's).

Small sizes: grids of R = 16 with 4 and 8 components, 64 rays of 8 + 8
samples. Inputs are drawn with numpy from a seed; JAX's parameters reach
the port through ``params_from_jax``, JAX's jitter draws are handed in."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import CPU, to_torch
import nerfstudio_tpu.fields.tensorf_field as jtensorf_field
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.data.scene_box import SceneBox as JSceneBox
from nerfstudio_tpu.engine.optimizers import build_optimizers
from nerfstudio_tpu.field_components import encodings as jenc
from nerfstudio_tpu.field_components import mlp as jmlp
from nerfstudio_tpu.model_components import losses as jlosses
from nerfstudio_tpu.model_components.renderers import background_color_override_context as jbg_override
from nerfstudio_tpu.model_components.scene_colliders import AABBBoxCollider as JAABBBoxCollider
from nerfstudio_tpu.models.tensorf import TensoRFModel as JTensoRF
from nerfstudio_tpu.models.tensorf import TensoRFModelConfig as JTensoRFConfig
from nerfstudio_tpu.pipelines.base_pipeline import TrainState as JTrainState
from nerfstudio_tpu.utils import math as jmath
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.engine.optimizers import PerGroupAdam
from nerfstudio_torch.field_components import encodings
from nerfstudio_torch.model_components import losses, renderers
from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
from nerfstudio_torch.model_components.scene_colliders import AABBBoxCollider
from nerfstudio_torch.models.tensorf import TensoRFModel, TensoRFModelConfig
from nerfstudio_torch.pipelines.base_pipeline import TrainState
from nerfstudio_torch.utils import math as tmath
from nerfstudio_torch.utils.convert import params_from_jax

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))  # the Blender parser's scene box
TINY = dict(init_resolution=16, num_den_components=4, num_color_components=8, appearance_dim=6,
            num_uniform_samples=8, num_samples=8)
RAYS = 64
# K8's gathers are the same float32 products on both sides (values 1e-6
# absolute); gradients scatter the cotangents in another order (1e-5 of
# their peak), as tests/test_torch_interp.py holds K8 itself.
VALUE_ATOL, GRAD_REL = 1e-6, 1e-5


# --------------------------------------------------------------------------
# the encodings and tv_loss


def _positions(n, seed):
    """(n, 3) positions in [-1.2, 1.2]^3 (some outside the grid), a few on
    the grid's edges and corners."""
    p = np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    p[:4] = [[-1, -1, -1], [1, 1, 1], [-1, 1, 0], [0.5, -1, 1]]
    return p


ENCODINGS = {
    "cp": (lambda: jenc.TensorCPEncoding(resolution=16, num_components=4),
           lambda: encodings.TensorCPEncoding(16, 4, device=CPU)),
    "vm": (lambda: jenc.TensorVMEncoding(resolution=16, num_components=8),
           lambda: encodings.TensorVMEncoding(16, 8, device=CPU)),
    "triplane-sum": (lambda: jenc.TriplaneEncoding(resolution=16, num_components=4),
                     lambda: encodings.TriplaneEncoding(16, 4, device=CPU)),
    "triplane-product": (lambda: jenc.TriplaneEncoding(resolution=16, num_components=8, reduce="product"),
                         lambda: encodings.TriplaneEncoding(16, 8, reduce="product", device=CPU)),
}


@pytest.mark.parametrize("kind", sorted(ENCODINGS))
def test_tensor_encoding_matches_jax(kind):
    """Values within VALUE_ATOL of JAX's from the same parameters (JAX's
    init, ``init_scale`` 0.1 normals, the same names and layouts), and the
    gradients of a random projection of the output, to the grids and to
    the positions, within GRAD_REL of their peak."""
    make_j, make_t = ENCODINGS[kind]
    jmod, tmod = make_j(), make_t()
    pos = _positions(500, 7)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(1), jnp.asarray(pos)))
    state = {k: to_torch(v) for k, v in params["params"].items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    tmod.load_state_dict(state)
    assert tmod.get_out_dim() == jmod.get_out_dim()
    cot = np.random.default_rng(8).normal(size=(500, tmod.get_out_dim())).astype(np.float32)
    want, (jg_params, jg_pos) = jax.jit(lambda p, x, c: (lambda o, pull: (o, pull(c)))(
        *jax.vjp(lambda p, x: jmod.apply(p, x), p, x)))(params, jnp.asarray(pos), jnp.asarray(cot))
    x = to_torch(pos).requires_grad_(True)
    got = tmod(x)
    assert got.shape == want.shape == (500, tmod.get_out_dim())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=VALUE_ATOL)
    got.backward(to_torch(cot))
    pairs = [(tmod.state_dict(keep_vars=True)[k].grad, jg_params["params"][k]) for k in state] + [(x.grad, jg_pos)]
    for g, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(g.numpy() - ref).max() <= GRAD_REL * np.abs(ref).max(), kind


def test_tensor_encoding_init_draws_init_scale_normals():
    """``reset_parameters`` draws N(0, init_scale^2) for every grid."""
    enc = encodings.TensorVMEncoding(64, 16, init_scale=0.3, device=CPU)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    for p in (enc.plane_coef, enc.line_coef):
        assert abs(float(p.detach().mean())) < 0.01 and abs(float(p.detach().std()) - 0.3) < 0.01


def test_tv_loss_matches_jax():
    """The total variation of (3, 8, 16, 16) grids within 1e-5 relative (two
    means of ~5,800 float32 squares, summed in another order: ~sqrt(n)
    ulps), its gradient (one difference per entry) within 1e-6."""
    grids = np.random.default_rng(9).normal(size=(3, 8, 16, 16)).astype(np.float32)
    want, jg = jax.value_and_grad(jlosses.tv_loss)(jnp.asarray(grids))
    g = to_torch(grids).requires_grad_(True)
    got = losses.tv_loss(g)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6 * np.abs(jg).max())


# --------------------------------------------------------------------------
# the AABB collider


def _collider_rays():
    """(origins, directions) (40, 3): rays from outside the box towards
    it, some that miss it, some from inside, and rays parallel to faces
    (direction components exactly 0, and under the 1e-10 guard)."""
    rng = np.random.default_rng(10)
    o = rng.normal(size=(40, 3)).astype(np.float32)
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(scale=0.3, size=(40, 3)).astype(np.float32) - o
    d[:8] = rng.normal(size=(8, 3))  # mostly misses
    o[8:12] = rng.uniform(-1, 1, (4, 3))  # inside the box
    o[12:16], d[12:16] = [[-3, 0.2, 0.3]] * 4, [[1, 0, 0], [1, 0, 1e-12], [1, -1e-11, 0], [1, 0, 0]]
    o[15] = [-3, 2.0, 0.3]  # parallel to y = 1.5, outside it: misses
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("training", [True, False])
def test_aabb_collider_matches_jax(training):
    """Nears and fars within 1e-6 relative of JAX's (the same slab test);
    ``near_plane`` 0.05 only in training; a ray that misses gets an empty
    interval (fars = nears + 1e-6 or more)."""
    o, d = _collider_rays()
    area = np.ones((40, 1), np.float32)
    jout = JAABBBoxCollider(JSceneBox(aabb=jnp.asarray(AABB)), near_plane=0.05)(
        JRayBundle(origins=o, directions=d, pixel_area=area), training=training)
    tout = AABBBoxCollider(AABB, near_plane=0.05)(RayBundle(to_torch(o), to_torch(d), to_torch(area)),
                                                  training=training)
    for k in ("nears", "fars"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)), rtol=1e-6, err_msg=k)
    nears, fars = tout.nears.numpy()[:, 0], tout.fars.numpy()[:, 0]
    assert nears.min() == (0.05 if training else 0.0) and np.all(fars >= nears)
    assert fars[15] - nears[15] == pytest.approx(1e-6, rel=0.5)  # parallel outside the slab: missed


def test_intersect_aabb_matches_jax():
    """``utils.math.intersect_aabb`` on the same rays: nears clipped at 0,
    misses at ``invalid_value`` on both; within 1e-6 relative."""
    o, d = _collider_rays()
    aabb = np.asarray(AABB, np.float32).reshape(-1)
    want = jmath.intersect_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    got = tmath.intersect_aabb(to_torch(o), to_torch(d), to_torch(aabb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert (got[0].numpy() == 1e10).sum() >= 2


# --------------------------------------------------------------------------
# the model: one training step, an eval chunk


def _rays(seed, n=RAYS):
    """(origins, directions, pixel areas) of rays from radius 4 towards the
    scene's middle, as the Blender cameras look."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 4 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.3, size=(n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full((n, 1), 1e-4, np.float32)


def _jax_model(train, float32=False):
    """JAX's tiny TensoRF; with ``float32`` its head MLP computes in float32."""
    mlp = functools.partial(jmlp.MLP, dtype=jnp.float32) if float32 else jmlp.MLP
    orig = jtensorf_field.MLP
    jtensorf_field.MLP = mlp
    cfg = JTensoRFConfig(**TINY)
    model = JTensoRF(config=cfg, scene_aabb=AABB, num_train_data=4, train=train)
    return model, cfg, lambda: setattr(jtensorf_field, "MLP", orig)


def _torch_model(params, train, float32=False):
    model = TensoRFModelConfig(**TINY).setup(scene_aabb=AABB, num_train_data=4, device=CPU).train(train)
    model.load_state_dict(params_from_jax(params, model))
    if float32:
        model.field.head.dtype = torch.float32
    return model


@pytest.fixture(scope="module")
def params():
    """JAX's init of the tiny model, as numpy."""
    model, _, restore = _jax_model(True)
    o, d, a = _rays(0)
    try:
        p = jax.jit(lambda k: model.init(k, JRayBundle(origins=o, directions=d, pixel_area=a), key=k))(
            jax.random.PRNGKey(0))
    finally:
        restore()
    return jax.device_get(p)


@pytest.mark.parametrize("float32", [False, True])
def test_training_step_matches_jax(params, float32):
    """One step's loss terms and gradients from the same parameters, rays,
    RGBA ground truth (transparent, opaque and partial pixels) and JAX's
    jitter draws (the uniform sampler's one per ray, the PDF sampler's
    nine). Loss terms within 1e-5 relative. Gradients within 1e-4 of each
    parameter's peak (measured <= 4.5e-5): the grids and ``B`` are float32
    and the head's bfloat16 products round alike on both sides. As shipped
    the head's own gradients land up to 1% off JAX's (its bias gradients
    sum bfloat16 cotangents in another order): they are held to 2e-2 there
    and to 1e-4 with the head in float32, as the nerfacto-family step tests hold
    theirs."""
    jmodel, jcfg, restore = _jax_model(True, float32)
    o, d, a = _rays(1)
    gt = np.random.default_rng(2).uniform(size=(RAYS, 4)).astype(np.float32)
    gt[:16, 3], gt[16:32, 3] = 0.0, 1.0
    key = jax.random.PRNGKey(5)
    jrb = JRayBundle(origins=o, directions=d, pixel_area=a)

    def loss_fn(p):
        out = jmodel.apply(p, jrb, key=key)
        terms = jmodel.get_loss_dict(out, {"image": jnp.asarray(gt)}, None, p, config=jcfg)
        return sum(terms.values()), terms

    try:
        (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        restore()
    k1, k2, _ = jax.random.split(key, 3)
    draws = SamplerUniforms(None, (to_torch(jax.random.uniform(k1, (RAYS, 1))),
                                   to_torch(jax.random.uniform(k2, (RAYS, TINY["num_samples"] + 1)))))
    model = _torch_model(params, True, float32)
    out = model(RayBundle(to_torch(o), to_torch(d), to_torch(a)), uniforms=draws)
    terms = model.get_loss_dict(out, {"image": to_torch(gt)})
    assert set(terms) == set(jterms) == {"rgb_loss", "tv_reg_density", "tv_reg_color"}
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=1e-5, err_msg=k)
    sum(terms.values()).backward()
    jg = params_from_jax(jax.device_get(jgrads), model)
    for n, p in model.named_parameters():
        ref = jg[n].numpy()
        rel = 2e-2 if n.startswith("field.head.") and not float32 else 1e-4
        assert np.abs(p.grad.numpy() - ref).max() <= rel * np.abs(ref).max(), n


def test_l1_regularization_matches_jax(params):
    """The ``l1`` branch: ``l1_mult`` times the mean |.| of the density
    planes and lines, within 1e-6 relative; no TV terms."""
    jmodel, jcfg, restore = _jax_model(True)
    restore()
    import dataclasses

    jcfg = dataclasses.replace(jcfg, regularization="l1")
    want = jmodel.get_loss_dict({"rgb": jnp.zeros((2, 3)), "accumulation": jnp.zeros((2, 1))},
                                {"image": jnp.zeros((2, 3))}, None, params, config=jcfg)
    model = TensoRFModelConfig(regularization="l1", **TINY).setup(scene_aabb=AABB, device=CPU)
    model.load_state_dict(params_from_jax(params, model))
    got = model.get_loss_dict({"rgb": torch.zeros((2, 3)), "accumulation": torch.zeros((2, 1))},
                              {"image": torch.zeros((2, 3))})
    assert set(got) == set(want) == {"rgb_loss", "l1_reg"}
    np.testing.assert_allclose(float(got["l1_reg"]), float(want["l1_reg"]), rtol=1e-6)


@pytest.mark.parametrize("color", [(1.0, 1.0, 1.0), (0.2, 0.5, 0.9)])
def test_eval_chunk_under_the_override_matches_jax(params, color):
    """An eval chunk (no jitter, nears 0) under the background override:
    white, the Blender protocol's, and a colour no model ships, so the
    override shows. rgb, accumulation and median depth within 1e-3 of
    JAX's (the head's bfloat16 products); rgb is the composite plus the
    override times 1 - accumulation."""
    jmodel, _, restore = _jax_model(False)
    restore()
    o, d, a = _rays(3)
    with jbg_override(jnp.asarray(color)):
        want = jax.jit(lambda p: jmodel.apply(p, JRayBundle(origins=o, directions=d, pixel_area=a)))(params)
    model = _torch_model(params, False)
    with torch.no_grad(), renderers.background_color_override_context(torch.tensor(color)):
        got = model(RayBundle(to_torch(o), to_torch(d), to_torch(a)))
    assert set(got) == {"rgb", "accumulation", "depth"} and set(want) == set(got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-3, err_msg=k)
    with torch.no_grad():
        plain = model(RayBundle(to_torch(o), to_torch(d), to_torch(a)))
    acc = got["accumulation"]
    shift = (torch.tensor(color) - 1.0) * (1.0 - acc)  # the model's own white, replaced
    np.testing.assert_allclose(got["rgb"].numpy(), (plain["rgb"] + shift).numpy(), atol=1e-6)
    assert renderers.BACKGROUND_COLOR_OVERRIDE is None


# --------------------------------------------------------------------------
# the upsample hook


def test_upsample_resolutions_match_jax():
    for cfg in (dict(), dict(init_resolution=16, final_resolution=24, upsampling_iters=(2, 4))):
        assert TensoRFModel.upsample_resolutions(TensoRFModelConfig(**cfg)) == \
            JTensoRF.upsample_resolutions(JTensoRFConfig(**cfg))
    assert TensoRFModel.upsample_resolutions(TensoRFModelConfig()) == [152, 180, 213, 253, 300]


def test_upsample_hook_matches_jax(params):
    """At ``upsampling_iters=(2, 4)`` (16 -> 20 -> 24) after three Adam
    steps on both sides: no change at step 1; at step 2 every plane and
    line resampled within 1e-6 of the peak of JAX's ``jax.image.resize``
    (the other parameters untouched), the optimizer's count and moments
    back to 0 as ``tx.init(new_params)`` leaves optax's, its rate the
    schedule's first (1e-3), and the next update on both sides from the
    same gradients equal within 1e-6 of its peak (Adam's bias correction
    restarted: a first step moves each entry by about the rate)."""
    cfg = dict(TINY, final_resolution=24, upsampling_iters=(2, 4))
    jcfg = JTensoRFConfig(**cfg)
    jmodel = JTensoRF(config=jcfg, scene_aabb=AABB, num_train_data=4, train=True)
    optimizers = get_method("tensorf").optimizers
    import nerfstudio_tpu.configs.method_configs as jmc

    tx = build_optimizers(jmc.get_method("tensorf").optimizers, params)
    jpipe = types.SimpleNamespace(model_train=jmodel, model_eval=None, tx=tx, _train_step=None, _eval_chunk=None)
    jstate = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32), aux=None)
    model = TensoRFModelConfig(**cfg).setup(scene_aabb=AABB, device=CPU).train()
    model.load_state_dict(params_from_jax(params, model))
    state = TrainState(PerGroupAdam(optimizers, model))
    rng = np.random.default_rng(11)
    update = jax.jit(tx.update)

    def step_both(jstate):
        grads = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), jstate.params)
        updates, opt = update(grads, jstate.opt_state, jstate.params)
        tg = params_from_jax(grads, model)
        state.optimizer.zero_grad()
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        state.optimizer.step()
        return jstate.replace(params=optax.apply_updates(jstate.params, updates), opt_state=opt)

    for _ in range(3):
        jstate = step_both(jstate)
    jhook = JTensoRF.make_upsample_hook(jpipe, jcfg)
    hook = TensoRFModel.make_upsample_hook(model, model.config)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert hook(state, 1) is state and state.optimizer.count == 3
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    jstate = jhook(jstate, 2, None)
    hook(state, 2)
    jp = params_from_jax(jax.device_get(jstate.params), model)
    for n, p in model.named_parameters():
        assert tuple(p.shape) == tuple(jp[n].shape), n
        if n.endswith("_coef"):
            assert p.shape[-1] == 20
            assert np.abs(p.detach().numpy() - jp[n].numpy()).max() <= 1e-6 * np.abs(jp[n].numpy()).max(), n
        else:
            assert torch.equal(p.detach(), before[n]), n
    adam, sched = jstate.opt_state.inner_states["field"].inner_state[0]
    assert int(adam.count) == int(sched.count) == 0 == state.optimizer.count
    assert all(not jnp.any(m) for m in jax.tree_util.tree_leaves((adam.mu, adam.nu)))
    assert all(not opt.state for opt in state.optimizer.optimizers.values())
    jrate = jmc.get_method("tensorf").optimizers["field"]["scheduler"].build(1e-3)(int(sched.count))
    assert state.optimizer.learning_rates() == {"field": pytest.approx(float(jrate), rel=1e-7)} == {"field": 1e-3}
    model.load_state_dict(jp)  # the same start, so the update alone compares
    jstate = step_both(jstate)
    jp = params_from_jax(jax.device_get(jstate.params), model)
    for n, p in model.named_parameters():
        delta = p.detach().numpy() - jp[n].numpy()
        assert np.abs(delta).max() <= 1e-6 * max(np.abs(jp[n].numpy()).max(), 1.0), n
    assert int(jstate.opt_state.inner_states["field"].inner_state[0][0].count) == 1 == state.optimizer.count
