"""instant-ngp and instant-ngp-bounded in the port against the JAX
reference on the CPU, at a tiny size: an L4 F4 T=2^10 block-layout field
(the config has no width fields: its MLPs keep the shipped 64), a 16^3
occupancy grid, 32 probes and 16 samples a ray, 64 rays, on the tool's
``blender`` scene at 16^2 through the Blender parser without an alpha
colour (the RGBA ground truth is blended over the background the
renderer drew).

The random background and the loss blend over it equal JAX's given JAX's
draw (1e-6). ``probe_density`` is exact. ``OccupancyGridSampler`` in both
variants (uniform probes in the box; piecewise probes through the
contracted cube) and both modes (JAX's jitter handed in; the eval
midpoints): the probes' weights exact, the sample starts and ends within
1e-5 relative. The grid refresh (every cell, JAX's jitter handed in, live
tables) to 1e-4 relative on the densities and 99.9% of the cells. One
training step per variant before the grid warm-up (step 100) and after it
(step 304, over the refreshed grid), the MLPs in float32 on both sides and
flat tables (one value per level and feature, so K1's rounding choices do
not move the step): the loss within 2e-3 relative, each MLP gradient within
1e-3 of its peak, the table's gradient summed per level and feature within
1e-3 of the largest sum. An eval view through K3's twin, rgb within 1e-4.
The method configs equal JAX's; ``scripts/train.py instant-ngp`` trains,
evaluates and resumes bit-equal with the grid in the checkpoint; the gate
runner takes both methods at the JAX records' steps."""

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_occupancy_draws, jax_step_draws, to_torch
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.data.dataparsers.blender_dataparser import BlenderDataParserConfig as JBlender
from nerfstudio_tpu.data.scene_box import SceneBox as JSceneBox
from nerfstudio_tpu.field_components.spatial_distortions import SceneContraction as JContraction
from nerfstudio_tpu.model_components import ray_samplers as jrs
from nerfstudio_tpu.model_components import renderers as jrend
from nerfstudio_tpu.model_components.scene_colliders import AABBBoxCollider as JAABBCollider
from nerfstudio_tpu.model_components.scene_colliders import NearFarCollider as JNearFar
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.model_components import ray_samplers as trs
from nerfstudio_torch.model_components import renderers as trend
from nerfstudio_torch.model_components.scene_colliders import AABBBoxCollider, NearFarCollider
from nerfstudio_torch.ops import occupancy as tocc
from nerfstudio_torch.pipelines.base_pipeline import StepDraws
from nerfstudio_torch.utils.convert import occupancy_from_jax, params_from_jax, trainer_checkpoint_from_jax

REPO = Path(__file__).resolve().parent.parent
RAYS = 64
TINY = dict(num_levels=4, log2_hashmap_size=10, max_res=64, grid_resolution=16, num_coarse_probes=32,
            num_samples_per_ray=16, eval_num_rays_per_chunk=128)
METHODS = ("instant-ngp", "instant-ngp-bounded")
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))  # the Blender parser's scene box


# --------------------------------------------------------------------------
# the random background


@pytest.mark.parametrize("override", [False, True], ids=["random", "override"])
def test_random_background_and_loss_blend_match_jax(override):
    """``render_rgb`` over ``"random"`` with JAX's draw handed in returns
    JAX's composite and the drawn colour; the loss blends an RGBA ground
    truth over that colour as JAX does (1e-6). Under the eval override the
    override wins over ``"random"`` on both sides."""
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(37, 8, 3)).astype(np.float32)
    w = (rng.uniform(size=(37, 8, 1)) / 8).astype(np.float32)
    gt = rng.uniform(size=(37, 4)).astype(np.float32)
    gt[:4, 3] = [0.0, 1.0, 0.5, 0.0]
    key = jax.random.PRNGKey(11)
    draw = to_torch(jax.random.uniform(key, (37, 3)))
    color = np.array([0.2, 0.5, 0.9], np.float32)

    def jax_side():
        out, bg = jrend.render_rgb(jnp.asarray(rgb), jnp.asarray(w), background_color="random", key=key,
                                   return_background=True)
        return out, bg, jrend.blend_background_for_loss_computation(out, None, jnp.asarray(gt), background=bg)[1]

    def torch_side():
        out, bg = trend.render_rgb(to_torch(rgb), to_torch(w), background_color="random", return_background=True,
                                   background=draw)
        return out, bg, trend.blend_background_for_loss_computation(out, to_torch(gt), background=bg)[1]

    if override:
        with jrend.background_color_override_context(jnp.asarray(color)):
            want = jax_side()
        with trend.background_color_override_context(to_torch(color)):
            got = torch_side()
        np.testing.assert_array_equal(got[1].numpy(), np.broadcast_to(color, (37, 3)))
    else:
        want, got = jax_side(), torch_side()
        np.testing.assert_array_equal(got[1].numpy(), draw.numpy())
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_random_background_draws_from_the_generator():
    """Without a draw the colours come from the generator, uniform in
    [0, 1), one per ray and channel; neither raises; a draw of another
    shape raises."""
    gen = torch.Generator().manual_seed(0)
    bg = trend.get_background_color("random", (500, 3), "cpu", generator=gen)
    again = trend.get_background_color("random", (500, 3), "cpu", generator=torch.Generator().manual_seed(0))
    assert bg.shape == (500, 3) and torch.equal(bg, again) and 0.0 <= float(bg.min()) and float(bg.max()) < 1.0
    assert abs(float(bg.mean()) - 0.5) < 0.05
    with pytest.raises(ValueError, match="generator or a draw"):
        trend.get_background_color("random", (5, 3), "cpu")
    with pytest.raises(ValueError, match="draw of shape"):
        trend.get_background_color("random", (5, 3), "cpu", draw=torch.zeros(4, 3))


# --------------------------------------------------------------------------
# the probes and the sampler


def _jax_grid(res=16, aabb=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), seed=0):
    """A JAX grid with EMA densities of a few magnitudes and the cells
    above 0.5 occupied (its packed views consistent)."""
    dens = (np.random.default_rng(seed).uniform(0, 1, res**3) ** 3 * 20).astype(np.float32)
    binary = dens > 0.5
    grid = jocc.init_occupancy_grid(aabb, res)
    return grid.replace(densities=jnp.asarray(dens), binary=jnp.asarray(binary),
                        binary_rows=jocc._pack_rows(jnp.asarray(binary), res),
                        density_rows=jocc._pack_rows(jnp.asarray(dens), res))


def test_probe_density_matches_jax():
    """The nearest cell's EMA density, with the reference's border clamping,
    exact, on positions inside, on and outside the grid's aabb."""
    jgrid = _jax_grid(aabb=((-1.0, -0.5, 0.0), (1.0, 1.5, 2.0)))
    grid = occupancy_from_jax(jgrid)
    pts = np.random.default_rng(4).uniform(-1.5, 2.5, (5000, 3)).astype(np.float32)
    pts[:4] = [[-1.0, -0.5, 0.0], [1.0, 1.5, 2.0], [0.0, 0.5, 1.0], [0.999, 1.499, 1.999]]
    want = np.asarray(jocc.probe_density(jgrid, jnp.asarray(pts)))
    np.testing.assert_array_equal(tocc.probe_density(grid, to_torch(pts)).numpy(), want)
    assert len(np.unique(want)) > 100


def _bundles(n=48, seed=5):
    """Matching ray bundles from radius 2.5 towards the middle, without
    nears and fars (the colliders set them)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.4, size=(n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = np.full((n, 1), 1e-4, np.float32)
    return JRayBundle(origins=o, directions=d, pixel_area=a), RayBundle(to_torch(o), to_torch(d), to_torch(a))


def _cdf_units(edges, weights, x):
    """The probes' CDF at ``x`` (spacing domain), in float64: piecewise
    linear through the probe ``edges`` with the weights' cumulative shares
    (the inverse the PDF sampler takes, no padding)."""
    w = weights.astype(np.float64)
    cdf = np.concatenate([np.zeros_like(w[..., :1]), np.cumsum(w, axis=-1) / w.sum(-1, keepdims=True)], axis=-1)
    return np.stack([np.interp(x[r], edges[r], cdf[r]) for r in range(x.shape[0])])


@pytest.mark.parametrize("train", [True, False], ids=["jitter", "eval"])
@pytest.mark.parametrize("bounded", [True, False], ids=["bounded", "contracted"])
def test_occupancy_grid_sampler_matches_jax(bounded, train):
    """Both variants of the sampler, as the models build them, over a grid
    with about a third of its cells occupied: the probes' weights (1 inside
    the aabb in an occupied cell, 1e-3 elsewhere) exactly JAX's; the PDF's
    sample edges within 1e-5 relative (JAX's jitter handed in, or the eval
    midpoints), or, for at most 1% of them, within 1e-6 in CDF units: an
    edge inside an empty bin sits where the CDF rises by 1e-3 of a bin's
    share, so the cumsum's last ulp moves it by up to ~1e-4 relative
    (measured)."""
    from nerfstudio_torch.models.instant_ngp import InstantNGPModel

    jrb, trb = _bundles()
    if bounded:
        jgrid = _jax_grid(aabb=AABB)
        jrb = JAABBCollider(JSceneBox(aabb=jnp.asarray(AABB)), near_plane=0.01)(jrb, training=train)
        trb = AABBBoxCollider(AABB, near_plane=0.01)(trb, training=train)
        jkw, tkw = {}, {}
    else:
        jgrid = _jax_grid()
        jrb, trb = JNearFar(0.05, 1000.0)(jrb, training=train), NearFarCollider(0.05, 1000.0)(trb, training=train)
        jkw = dict(coord_fn=lambda p: (JContraction(order="inf")(p) + 2.0) / 4.0,
                   initial_sampler=jrs.UniformLinDispPiecewiseSampler(32, train_stratified=False))
        tkw = dict(coord_fn=InstantNGPModel.normalized_coords,
                   initial_sampler=trs.UniformLinDispPiecewiseSampler(32, train_stratified=False))
    grid = occupancy_from_jax(jgrid)
    jsampler = jocc.OccupancyGridSampler(num_coarse_probes=32, num_samples=16, **jkw)
    tsampler = tocc.OccupancyGridSampler(num_coarse_probes=32, num_samples=16, **tkw)
    key = jax.random.PRNGKey(9) if train else None

    @jax.jit
    def jax_side(rb, g):
        probes = (jsampler.initial_sampler or jrs.UniformSampler(32, train_stratified=False))(rb)
        pos = probes.frustums.get_positions()
        pos = jsampler.coord_fn(pos) if jsampler.coord_fn is not None else pos
        inside = jnp.all((pos > g.aabb[0]) & (pos < g.aabb[1]), axis=-1)
        w = jnp.where((jocc.probe_occupancy(g, pos) > 0.5) & inside, 1.0, 1e-3)
        s = jsampler(rb, g, key=key)
        return w, s.frustums.starts, s.frustums.ends, s.spacing_starts, s.spacing_ends

    jw, jstarts, jends, jspacing, jspacing_end = jax_side(jrb, jgrid)
    jitter = None
    if train:
        jitter = to_torch(jax.random.uniform(jax.random.split(key)[1], (48, 1)))
    probes = (tsampler.initial_sampler or trs.UniformSampler(32, train_stratified=False))(trb)
    w = tsampler.probe_weights(grid, probes)
    np.testing.assert_array_equal(w[..., 0].numpy(), np.asarray(jw))
    assert 0.1 < float((w == 1.0).float().mean()) < 0.9
    s = tsampler(trb, grid, uniforms=jitter)
    edges = lambda rs: np.concatenate([rs.spacing_starts[..., 0], rs.spacing_ends[..., -1:, 0]], -1)  # noqa: E731
    got, want = edges(s).astype(np.float64), np.concatenate([np.asarray(jspacing)[..., 0],
                                                             np.asarray(jspacing_end)[..., -1:, 0]], -1)
    close = np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-7
    # where the edge falls in an empty probe bin the inverse CDF divides by
    # its 1e-3 share, and the cumsum's last-ulp order moves the edge: there
    # the two must agree in CDF units (the probes' weights are equal)
    old = edges(probes).astype(np.float64)
    cdf_gap = np.abs(_cdf_units(old, w.numpy()[..., 0], got) - _cdf_units(old, w.numpy()[..., 0], want))
    assert cdf_gap[~close].max(initial=0.0) <= 1e-6 and close.mean() >= 0.99, (cdf_gap.max(), close.mean())
    for got_e, want_e in ((s.frustums.starts, jstarts), (s.frustums.ends, jends)):
        ok = close[:, :-1] if got_e is s.frustums.starts else close[:, 1:]
        np.testing.assert_allclose(got_e.numpy()[..., 0][ok], np.asarray(want_e)[..., 0][ok], rtol=1e-5, atol=1e-7)
    assert s.frustums.starts.shape == (48, 16, 1)


# --------------------------------------------------------------------------
# the model through the factories


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    """The tool's ``blender`` scene at 16^2: 4 RGBA train views, 2 test."""
    root = tmp_path_factory.mktemp("scenes") / "blender"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"), str(root), "--scene", "blender",
                    "--hw", "16", "--n-train", "4", "--n-test", "2", "--n-points", "100"], check=True,
                   capture_output=True, timeout=300)
    return root


def _widen(params, seed, flat):
    """The field's table uniform in +-1 (``flat``: one value per level and
    feature, lane ``slot*8F + c*F + f`` holding feature f)."""
    params = jax.tree_util.tree_map(np.copy, params)
    enc = params["params"]["field"]["mlp_base"]["encoding"]
    L, S, _ = enc["hash_table"].shape
    F = 128 * S // 2 ** TINY["log2_hashmap_size"]
    rng = np.random.default_rng(seed)
    if flat:
        values = rng.uniform(-1, 1, (L, F)).astype(np.float32)
        enc["hash_table"] = np.ascontiguousarray(np.broadcast_to(np.tile(values, 128 // F)[:, None, :], (L, S, 128)))
    else:
        enc["hash_table"] = rng.uniform(-1, 1, (L, S, 128)).astype(np.float32)
    return params


def _build(method, scene):
    """JAX's and the port's factory-built ``method`` at TINY on the scene
    (the Blender parser, no alpha colour), the port's MLPs in float32.
    Returns (JAX pipeline, its host state, its config, the port's
    pipeline, its state, its config)."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.field_components.mlp import MLP
    from nerfstudio_torch.pipelines.factory import build_pipeline

    jconfig = jget_method(method)
    jconfig.model = dataclasses.replace(jconfig.model, **TINY)
    jconfig.data, jconfig.dataparser = scene, JBlender(data=scene, alpha_color=None)
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    config = get_method(method)
    config.data, config.dataparser = scene, BlenderDataParserConfig(data=scene, alpha_color=None)
    config.machine.device_type = "cpu"
    config.datamanager.train_num_rays_per_batch = RAYS
    for k, v in TINY.items():
        setattr(config.model, k, v)
    pipe, state, config = build_pipeline(config)
    for m in pipe.model.modules():
        if isinstance(m, MLP):
            m.dtype = torch.float32
    return jpipe, jax.device_get(jstate), jconfig, pipe, state, config


@pytest.fixture(scope="module", params=METHODS)
def pair(request, blender):
    return _build(request.param, blender)


def _restore(pair, params, aux=None):
    """Both sides at ``params`` (and JAX's grid ``aux``); returns JAX's state."""
    jpipe, host_state, _, pipe, state, _ = pair
    host = host_state.replace(params=params, aux=host_state.aux if aux is None else aux)
    ttrainer.restore_train_state(pipe, state, trainer_checkpoint_from_jax(host, pipe.model, state.optimizer))
    return jax.tree_util.tree_map(jnp.asarray, host)


@contextlib.contextmanager
def jax_float32_mlps():
    """Every MLP of JAX's nerfacto field (and of its proposal nets) computes
    in float32 inside the block, as the port's do with ``dtype`` float32
    (a jitted function traced inside keeps it)."""
    import nerfstudio_tpu.field_components.mlp as jmlp
    import nerfstudio_tpu.fields.nerfacto_field as jfield

    saved = jfield.MLP, jmlp.MLP
    jfield.MLP, jmlp.MLP = (functools.partial(c, dtype=jnp.float32) for c in saved)
    try:
        yield
    finally:
        jfield.MLP, jmlp.MLP = saved


def _refresh(pair, jstate, step, key):
    """JAX's hook and the port's at ``step`` with JAX's jitter, the MLPs in
    float32 on both sides; returns JAX's state after it."""
    jpipe, _, jconfig, pipe, state, _ = pair
    with jax_float32_mlps():
        jstate = jpipe.aux_update_fn(jstate.replace(step=jnp.asarray(step, jnp.int32)), step, key)
    res = jconfig.model.grid_resolution
    _, jitter = jax_occupancy_draws(key, res, res**3)
    pipe.aux_update_fn(state, step, jitter=jitter)
    return jstate


def _bounded_refresh_start(pair):
    """JAX's params and grid for the bounded variant's refresh: flat tables,
    the density's output bias lowered by 12 (a constant density d of about
    1e-5 in the box, under the 0.01 threshold) and a grid whose EMA
    densities spread over d * 10^[-1, 1], so the refresh's maximum, mean and
    threshold all act. World positions reach the field through
    ``SceneBox`` normalisation, whose float32 rounding XLA fuses
    differently (the positions' last bits differ on ~1% of the cells, and
    K1's stochastic rounding hashes those bits): with flat tables the
    density does not depend on them."""
    jpipe, host_state, jconfig, pipe, state, _ = pair
    params = _widen(host_state.params, 1, flat=True)
    params["params"]["field"]["mlp_base"]["mlp"]["layers_1"]["bias"][0] -= 12.0
    _restore(pair, params)
    with torch.no_grad():
        d = float(pipe.model.field.density_fn(torch.zeros((1, 3)))[0, 0])
    res = jconfig.model.grid_resolution
    dens = (d * 10 ** np.random.default_rng(6).uniform(-1, 1, res**3)).astype(np.float32)
    grid = jocc.init_occupancy_grid(AABB, res)
    grid = jax.device_get(grid.replace(densities=jnp.asarray(dens), density_rows=jocc._pack_rows(jnp.asarray(dens),
                                                                                                 res)))
    return params, grid, d


def _refreshed_grid(pair, steps):
    """JAX's grid after its refreshes at ``steps``, some cells empty: with
    live tables (contracted) or from ``_bounded_refresh_start``."""
    jpipe, host_state, jconfig, pipe, state, config = pair
    if config.model.disable_scene_contraction:
        jstate = _restore(pair, *_bounded_refresh_start(pair)[:2])
    else:
        jstate = _restore(pair, _widen(host_state.params, 2, flat=False))
    for s in steps:
        jstate = _refresh(pair, jstate, s, jax.random.PRNGKey(s + 1))
    aux = jax.device_get(jstate.aux)
    assert 0.0 < float(np.mean(aux.binary)) < 1.0
    return aux


def test_grid_refresh_matches_jax(pair):
    """The whole grid refreshed at steps 256 and 272 (every cell at a
    jittered point; the contracted cube's positions through
    ``density_from_normalized`` with live tables; world positions through
    ``density_fn`` when bounded, from ``_bounded_refresh_start``), so the
    EMA decay shows: densities within 1e-4 relative, the cells on at least
    99.9%, some of them empty; at steps 100 and 260 the hook leaves the grid
    alone."""
    jpipe, host_state, jconfig, pipe, state, config = pair
    if config.model.disable_scene_contraction:
        params, grid, d = _bounded_refresh_start(pair)
        jstate = _restore(pair, params, grid)
        assert 1e-7 < d < 1e-3
    else:
        jstate = _restore(pair, _widen(host_state.params, 1, flat=False))
    for step in (256, 272):
        jstate = _refresh(pair, jstate, step, jax.random.PRNGKey(step))
        np.testing.assert_allclose(state.aux.densities.numpy(), np.asarray(jstate.aux.densities), rtol=1e-4,
                                   atol=1e-9)
        assert (state.aux.binary.numpy() == np.asarray(jstate.aux.binary)).mean() >= 0.999
    assert 0.01 < float(state.aux.binary.float().mean()) < 0.99
    assert torch.equal(state.aux.aabb, torch.tensor(pipe.model.grid_aabb(), dtype=torch.float32))
    before = state.aux
    for step in (100, 260):
        pipe.aux_update_fn(state, step)
        assert state.aux is before


def _jax_step(jpipe, params, aux, key):
    """(gradients, {"loss", "rgb_loss", "psnr"}) of JAX's train step with its
    draws from ``key``, every MLP in float32."""
    from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices

    dm, jmodel = jpipe.datamanager, jpipe.model_train
    k_pix, k_model = jax.random.split(key)
    idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

    def loss_fn(p):
        outputs = jmodel.apply(p, generate_rays_from_indices(dm.train_cameras, idx), key=k_model, model_aux=aux)
        metrics = jmodel.get_metrics_dict(outputs, batch, p)
        loss_dict = jmodel.get_loss_dict(outputs, batch, metrics, p, config=jmodel.config)
        return sum(loss_dict.values()), {**loss_dict, **metrics}

    with jax_float32_mlps():
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jax.device_get(grads), {"loss": loss, **jax.device_get(metrics)}


def ngp_step_draws(key, n_img, h, w):
    """The port's ``StepDraws`` holding what JAX's instant-ngp step draws
    from ``key``: the pixels, then from the model's key the sampler's key
    (whose second half jitters the PDF, one per ray) and the background's
    (one colour per ray)."""
    pixels = jax_step_draws(key, RAYS, n_img, h, w).pixels
    k_samp, k_bg = jax.random.split(jax.random.split(key)[1])
    jitter = to_torch(jax.random.uniform(jax.random.split(k_samp)[1], (RAYS, 1)))
    return StepDraws(pixels, trs.SamplerUniforms(None, (jitter,)), to_torch(jax.random.uniform(k_bg, (RAYS, 3))))


@pytest.mark.parametrize("step", [100, 304], ids=["before_warmup", "after_warmup"])
def test_training_step_matches_jax(pair, step):
    """One step at ``step`` with JAX's draws: before the warm-up over the
    fully occupied initial grid, after it over a grid refreshed at 288 and
    304 (``_refreshed_grid``, JAX's, converted: the refresh itself is held
    in ``test_grid_refresh_matches_jax``), then the step with flat tables. The
    loss, ``rgb_loss`` and PSNR within 2e-3; the MLP gradients within 1e-3
    of each one's peak; the table's per level and feature within 1e-3."""
    jpipe, host_state, jconfig, pipe, state, config = pair
    model = pipe.model
    aux = None
    if step >= jconfig.model.grid_warmup_steps:
        aux = _refreshed_grid(pair, (288, 304))
    flat = _widen(host_state.params, 3, flat=True)
    jstate = _restore(pair, flat, aux)
    state.step = step
    assert type(model).step_kwargs(step, config.model) == {}
    key = jax.random.PRNGKey(step)
    jgrads, jmetrics = _jax_step(jpipe, jstate.params, jstate.aux, key)
    jgrads = params_from_jax(jgrads, model)
    n_img, h, w = pipe.datamanager.train_images.shape[:3]
    assert pipe.datamanager.train_images.shape[-1] == 4  # RGBA: blended over the drawn colour
    tmetrics = pipe.train_step(state, draws=ngp_step_draws(key, n_img, h, w))
    assert set(tmetrics) == {"loss", "rgb_loss", "psnr"}
    for k in tmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=2e-3, err_msg=k)
    for n, p in model.named_parameters():
        ref = jgrads[n].numpy().astype(np.float64)
        got = p.grad.numpy().astype(np.float64)
        if n.endswith("hash_table"):
            F = 128 * got.shape[1] // 2 ** TINY["log2_hashmap_size"]
            got, ref = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, ref))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max() + 1e-12, err_msg=n)
    assert float(np.abs(jgrads["field.mlp_base.encoding.hash_table"].numpy()).max()) > 0


def test_eval_view_matches_jax(pair):
    """One test view rendered in 128-ray chunks through K3's twin, after a
    refresh so the grid has empty cells: rgb, accumulation and expected
    depth within 1e-4 of JAX's (rgb over black: the random background's
    eval colour, or the bounded variant's own), the MLPs in float32 on both
    sides."""
    jpipe, host_state, jconfig, pipe, state, config = pair
    aux = _refreshed_grid(pair, (256,))
    jstate = _restore(pair, _widen(host_state.params, 4, flat=False), aux)
    cam_idx = pipe.datamanager.eval_image(0)[0]
    with jax_float32_mlps():
        want = jpipe.render_camera(jstate.params, jpipe.datamanager.eval_cameras, cam_idx, 128, aux=jstate.aux)
    got = pipe.render_eval_camera(state, cam_idx, 128)
    assert {"rgb", "accumulation", "depth", "num_samples_per_ray"} <= set(got)
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(got["accumulation"].max()) > 0.05
    assert torch.all(got["num_samples_per_ray"] == TINY["num_samples_per_ray"])


# --------------------------------------------------------------------------
# the method configs and the entry points


@pytest.mark.parametrize("method", METHODS)
def test_method_config_matches_jax(method):
    """``get_method`` returns JAX's config field for field, and each
    optimizer group's kind, rate, eps and schedule."""
    from test_torch_vanilla_mipnerf import test_method_config_matches_jax as same_config

    same_config(method)
    from nerfstudio_torch.configs.method_configs import NOT_PORTED, get_method

    # generfacto, the last method refused before it, is ported: its config too
    assert "generfacto" not in NOT_PORTED
    same_config("generfacto")
    assert get_method(method).model.disable_scene_contraction == (method == "instant-ngp-bounded")


def test_train_eval_and_resume_bit_equal(blender, tmp_path, capsys):
    """``scripts/train.py instant-ngp`` on the CPU: 6 steps with the grid
    refreshed at steps 2 and 4, saved at 3; a second run resumed from that
    save to step 6. Both step-6 checkpoints are equal tensor for tensor (the
    model, the Adam moments and count, the grid, the generator); the grid
    in them is refreshed. ``scripts/eval.py`` evaluates the checkpoint."""
    from nerfstudio_torch.engine.trainer import read_checkpoint
    from nerfstudio_torch.scripts import eval as teval
    from nerfstudio_torch.scripts import train

    common = ["instant-ngp", "--data", str(blender), "--dataparser", "blender-data", "--machine.device_type", "cpu",
              "--trainer.vis", "none", "--trainer.output_dir", str(tmp_path / "out"), "--trainer.steps_per_save",
              "3", "--trainer.save_only_latest_checkpoint", "false", "--datamanager.train_num_rays_per_batch", "32",
              "--model.log2_hashmap_size", "10", "--model.num_levels", "4", "--model.max_res", "64",
              "--model.grid_resolution", "16", "--model.num_coarse_probes", "16", "--model.num_samples_per_ray", "8",
              "--model.grid_warmup_steps", "2", "--model.grid_update_every", "2", "--model.eval_num_rays_per_chunk",
              "256", "--trainer.max_num_iterations", "6"]
    train.main(common + ["--trainer.timestamp", "run1"])
    run1 = tmp_path / "out" / "blender" / "instant-ngp" / "run1"
    train.main(common + ["--trainer.timestamp", "run2", "--trainer.load_dir", str(run1 / "nerfstudio_models"),
                         "--trainer.load_step", "3"])
    assert "loaded checkpoint at step 3" in capsys.readouterr().out
    (_, a), (_, b) = (read_checkpoint(tmp_path / "out" / "blender" / "instant-ngp" / r / "nerfstudio_models", 6)
                      for r in ("run1", "run2"))

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y

    assert same(a, b)
    assert a["aux"]["resolution"] == 16 and float(a["aux"]["densities"].abs().max()) > 0
    info = teval.main([str(run1), "--output-path", str(tmp_path / "eval.json")])
    assert info["step"] == 6 and {"psnr", "ssim"} <= set(info["results"])


@pytest.mark.parametrize("method", METHODS)
def test_gate_runner_takes_both_methods(method, blender, tmp_path):
    """The gate runner trains 2 steps of each on the ``blender`` scene
    through the Blender parser, the RGBA ground truth blended over the
    renderer's background in the loss: instant-ngp evaluated over white
    (the parser's alpha colour, as JAX's runner has it), the bounded
    variant over black; the JAX records' steps and quality beside (none
    for the bounded variant)."""
    from nerfstudio_torch.scripts import gate

    small = ["--machine.device_type", "cpu", "--model.log2_hashmap_size", "10", "--model.num_levels", "4",
             "--model.max_res", "64", "--model.grid_resolution", "16", "--model.num_coarse_probes", "16",
             "--model.num_samples_per_ray", "8", "--datamanager.train_num_rays_per_batch", "32",
             "--model.eval_num_rays_per_chunk", "256"]
    result, run = gate.run_gate(method, blender, tmp_path / "gate", steps=2, overrides=small)
    assert result["scene"] == "blender" and result["steps"] == 2
    assert gate.GATE_STEPS[method] == {"instant-ngp": 5000, "instant-ngp-bounded": 3000}[method]
    dm = run["pipeline"].datamanager
    if method == "instant-ngp":
        record = json.loads((REPO / "benchmarks" / "gate_instant_ngp_blender.json").read_text())
        assert result["jax_record"] == {"psnr": record["metrics"]["psnr"], "ssim": record["metrics"]["ssim"]}
        assert record["steps"] == 5000
        assert torch.equal(dm.eval_dataset.alpha_color, torch.ones(3))
        for scene in ("masked", "unbounded"):
            assert gate.jax_record(method, scene) is not None
    else:
        assert result["jax_record"] is None and dm.eval_dataset.alpha_color is None
    assert dm.train_images.shape[-1] == 4  # RGBA: the loss blends it over the renderer's background
