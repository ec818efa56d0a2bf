"""Plain NeuS in the port against the JAX reference: the loss blend over an
RGBA ground truth, ``PDFSampler(include_original=True)``, ``NeuSSampler``
and its fixed-spread alphas, the SDF field's appearance embedding and
numerical gradients, one training step with JAX's draws handed in (loss,
gradients, parameters after two Adam steps), an eval render, the method
config and the gate runner's Blender route.

Inputs are drawn with numpy from a seed; the SDF field runs in float32 on
both sides. Parameters come from the JAX ``init`` through
``params_from_jax``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, HW, NO_HASH_LAUNCHES, NUM_IMAGES, init_params, jax_step_draws, orbit_c2w, to_torch
from test_torch_cli import _leaves
from test_torch_neus import TINY_FIELD, _rays_and_samples
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.engine.optimizers import build_optimizers
from nerfstudio_tpu.field_components.field_heads import FieldHeadNames as JNames
from nerfstudio_tpu.fields.sdf_field import SDFField as JSDFField
from nerfstudio_tpu.model_components import ray_samplers as jrs
from nerfstudio_tpu.model_components import renderers as jrenderers
from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices as j_rays_from_indices
from nerfstudio_tpu.model_components.scene_colliders import SphereCollider as JSphereCollider
from nerfstudio_tpu.models.base_model import render_camera as j_render_camera
from nerfstudio_tpu.models.neus import NeuSModel as JNeuS
from nerfstudio_tpu.models.neus import NeuSModelConfig as JNeuSConfig
from nerfstudio_tpu.pipelines.base_pipeline import VanillaPipeline as JPipeline
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
from nerfstudio_torch.engine.optimizers import PerGroupAdam, neus_optimizers
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.fields.sdf_field import NUMERICAL_GRADIENT_DELTA, SDFField
from nerfstudio_torch.model_components import ray_samplers, renderers
from nerfstudio_torch.model_components.ray_samplers import NeuSSampler, PDFSampler, SamplerUniforms, UniformSampler
from nerfstudio_torch.model_components.scene_colliders import SphereCollider
from nerfstudio_torch.models.base_model import render_camera
from nerfstudio_torch.models.neus import NeuSModel, NeuSModelConfig
from nerfstudio_torch.ops import hash_grid
from nerfstudio_torch.pipelines.base_pipeline import StepDraws, TrainState, VanillaPipeline
from nerfstudio_torch.utils.convert import params_from_jax, train_state_from_jax

# the shipped sampler's structure (a uniform round, four upsampling rounds
# at inv_s 64 * 2^i) at fewer samples per round
TINY_SAMPLER = dict(num_samples=16, num_samples_importance=16, num_upsample_steps=4)
TINY_NEUS = dict(TINY_FIELD, **TINY_SAMPLER)
RAYS = 48
# Bins within 1e-6: both sides take the same float32 steps, the CDF's
# cumulative sum and the SDF's products only in another order (~1e-7 on
# values in [0, 1]); a ray's euclidean edges run to ~3.
BIN_TOL = dict(rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the loss blend (reference renderers.py:97-119)


@pytest.mark.parametrize("color", ["black", "white", "last_sample", "random", (0.2, 0.5, 0.9)])
@pytest.mark.parametrize("with_background", [False, True])
def test_loss_blend_over_rgba_matches_jax(color, with_background):
    """An RGBA ground truth blended over ``background`` where the renderer
    hands one in, else over ``background_color`` (``last_sample`` and
    ``random`` over black); an RGB one passes as is. Exact: one product and
    one sum per channel on both sides."""
    rng = np.random.default_rng(10)
    pred = rng.uniform(size=(37, 3)).astype(np.float32)
    gt = rng.uniform(size=(37, 4)).astype(np.float32)
    gt[:5, 3] = [0.0, 1.0, 0.5, 0.0, 1.0]
    bg = rng.uniform(size=(37, 3)).astype(np.float32) if with_background else None
    jcolor = jnp.asarray(color, jnp.float32) if isinstance(color, tuple) else color
    _, want = jrenderers.blend_background_for_loss_computation(
        jnp.asarray(pred), jnp.zeros((37, 1)), jnp.asarray(gt), background_color=jcolor,
        background=None if bg is None else jnp.asarray(bg))
    got_pred, got = renderers.blend_background_for_loss_computation(
        to_torch(pred), to_torch(gt), background=None if bg is None else to_torch(bg), background_color=color)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got_pred, to_torch(pred))
    rgb = to_torch(gt[:, :3])
    assert renderers.blend_background_for_loss_computation(to_torch(pred), rgb, background_color=color)[1] is rgb


def test_neus_loss_blends_over_its_background_color():
    """NeuS's rgb loss passes the config's colour (reference neus.py:153-158):
    without a renderer background (eval outputs) a white config blends the
    ground truth over white, where the metrics (``background`` only) blend
    over black."""
    model = NeuSModelConfig(background_color="white", **TINY_NEUS).setup(device=CPU).eval()
    gt = torch.tensor([[0.2, 0.4, 0.6, 0.0], [0.2, 0.4, 0.6, 1.0]])
    outputs = {"rgb": torch.full((2, 3), 0.5), "accumulation": torch.zeros((2, 1))}
    loss = model.get_loss_dict(outputs, {"image": gt})["rgb_loss"]
    want = ((0.5 - 1.0) ** 2 * 3 + sum((0.5 - v) ** 2 for v in (0.2, 0.4, 0.6))) / 6
    assert float(loss) == pytest.approx(want, rel=1e-6)


# --------------------------------------------------------------------------
# the samplers


def _bundles(n_rays, seed):
    """(JAX, torch) ray bundles from a sphere of radius 1.6 towards the
    origin's neighbourhood, their nears and fars from the unit sphere."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o = 1.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = (rng.normal(scale=0.3, size=(n_rays, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    area = np.ones((n_rays, 1), np.float32)
    jrb = JSphereCollider(center=jnp.zeros(3), radius=1.0)(JRayBundle(origins=o, directions=d, pixel_area=area))
    trb = SphereCollider((0.0, 0.0, 0.0), 1.0)(RayBundle(to_torch(o), to_torch(d), to_torch(area)))
    return jrb, trb


def _assert_same_bins(got, want):
    """Edges within BIN_TOL; the deltas, differences of two euclidean edges
    near ~3, within twice the edges' tolerance there."""
    for name in ("spacing_starts", "spacing_ends"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name,
                                   **BIN_TOL)
    for name in ("starts", "ends"):
        np.testing.assert_allclose(getattr(got.frustums, name).numpy(), np.asarray(getattr(want.frustums, name)),
                                   err_msg=name, **BIN_TOL)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas), err_msg="deltas", rtol=0,
                               atol=2 * (BIN_TOL["atol"] + 3 * BIN_TOL["rtol"]))


def _sphere_sdf(xp):
    """A sphere of radius 0.5 as the sampler's SDF, on either side."""
    if xp is jnp:
        return lambda rs: jnp.linalg.norm(rs.frustums.get_positions(), axis=-1, keepdims=True) - 0.5
    return lambda rs: torch.linalg.norm(rs.frustums.get_positions(), dim=-1, keepdim=True) - 0.5


@pytest.mark.parametrize("train", [True, False])
def test_pdf_include_original_matches_jax(train):
    """The new edges merged with the old ones and sorted (reference
    :212-213): 9 + 7 edges give 15 samples, within BIN_TOL of JAX's, the
    jitter drawn from JAX's key (training) or the eval midpoints; gradient
    stopped."""
    jrb, trb = _bundles(40, 11)
    k_u, k_p = jax.random.split(jax.random.PRNGKey(3))
    u = jax.random.uniform(k_u, (40, 1))
    jprev = jrs.UniformSampler(8, single_jitter=True)(jrb, key=k_u)
    tprev = UniformSampler(8, single_jitter=True)(trb, uniforms=to_torch(u))
    w = np.random.default_rng(12).uniform(size=(40, 8, 1)).astype(np.float32)
    w[0] = 0.0  # the degenerate-histogram guard
    jpdf = jrs.PDFSampler(num_samples=6, include_original=True, single_jitter=True, histogram_padding=1e-5)
    want = jpdf(jrb, jprev, jnp.asarray(w), key=k_p if train else None)
    jitter = to_torch(jax.random.uniform(k_p, (40, 1))) if train else None
    tw = to_torch(w).requires_grad_(True)
    got = PDFSampler(num_samples=6, include_original=True, single_jitter=True, histogram_padding=1e-5)(
        trb, tprev, tw, uniforms=jitter)
    assert got.spacing_starts.shape == (40, 15, 1) and not got.spacing_starts.requires_grad
    _assert_same_bins(got, want)
    edges = torch.cat([got.spacing_starts[..., 0], got.spacing_ends[..., -1:, 0]], dim=-1)
    assert bool((edges[:, 1:] >= edges[:, :-1]).all())


def test_alphas_from_sdf_match_jax():
    """Fixed-spread NeuS alphas (reference :374-395) on SDF values that
    fall, rise and stay flat along the rays, at the four rounds' spreads:
    the slope clamped to [-1e3, 0], the last alpha 0; within 1e-6."""
    jsamples, tsamples = _rays_and_samples(24, 20, 13)
    sdf = np.random.default_rng(14).normal(scale=0.3, size=(24, 20, 1)).astype(np.float32)
    sdf[0, :, 0] = np.linspace(1.0, -1.0, 20)
    sdf[1, :, 0] = np.linspace(-1.0, 1.0, 20)
    sdf[2, :, 0] = 0.0
    for inv_s in (64.0, 128.0, 256.0, 512.0):
        want = np.asarray(jrs.NeuSSampler._alphas_from_sdf(jsamples, jnp.asarray(sdf), inv_s))
        got = NeuSSampler._alphas_from_sdf(tsamples, to_torch(sdf), inv_s).numpy()
        assert got.shape == (24, 20, 1) and np.all(got[:, -1] == 0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=str(inv_s))


def _edges(rs):
    """(..., S+1) spacing edges of a RaySamples of either package."""
    starts, ends = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)[..., 0]
                    for x in (rs.spacing_starts, rs.spacing_ends))
    return np.concatenate([starts, ends[..., -1:]], axis=-1).astype(np.float64)


def _cdf_units(edges, weights, padding, x):
    """The round's CDF at ``x``, in float64: piecewise linear through
    ``edges`` with the padded weights' cumulative shares (the inverse the
    PDF sampler takes)."""
    w = weights.astype(np.float64) + padding
    cdf = np.concatenate([np.zeros_like(w[..., :1]), np.cumsum(w, axis=-1) / w.sum(-1, keepdims=True)], axis=-1)
    return np.stack([np.interp(x[r], edges[r], cdf[r]) for r in range(x.shape[0])])


def _jax_rounds(jrb, key):
    """JAX's samples after 0 to 4 upsampling rounds of the shipped
    ``NeuSSampler`` over the sphere SDF (the sampler with fewer rounds draws
    the same keys for those it runs), and the jitters it draws: the uniform
    round's, then one per round, (32, 1) each (None without a key)."""
    k0 = None if key is None else jax.random.split(key)[0]
    rounds = [jrs.UniformSampler(64, single_jitter=True)(jrb, key=k0)]
    rounds += [jrs.NeuSSampler(num_upsample_steps=i, num_samples_importance=16 * i)(jrb, _sphere_sdf(jnp), key=key)
               for i in range(1, 5)]
    if key is None:
        return rounds, (None,) * 5
    k0, k = jax.random.split(key)
    draws = [jax.random.uniform(k0, (32, 1))]
    for _ in range(4):
        kp, k = jax.random.split(k)
        draws.append(jax.random.uniform(kp, (32, 1)))
    return rounds, tuple(to_torch(u) for u in draws)


@pytest.mark.parametrize("train", [True, False])
def test_neus_sampler_rounds_match_jax(train):
    """Each round of the upsampling (reference :331-395) on JAX's own
    samples of the round before, JAX's draws handed in (training) or the
    eval midpoints, over a sphere SDF: the shipped 64 + 4 x 16 samples (65
    -> 82 -> 99 -> 116 -> 133 edges). The uniform round's edges within
    BIN_TOL; in each upsampling round the SDF within 1e-6, the CDF that
    the weights make within 1e-5 at every knot (a weight is a ratio
    (prev - next + 1e-5) / (prev + 1e-5) of two close sigmoids at inv_s up
    to 512: a tiny weight may differ by a few per cent, measured, and
    moves the CDF by no more than its size), every earlier edge kept
    exactly,
    and every new edge within 1e-6 of JAX's. That is the sampler's
    own scale: with histogram padding 1e-5 an edge drawn inside a bin that
    holds ~1e-5 of the weight moves by ~1e5 bin widths per unit of CDF,
    so the float32 CDFs' last-bit differences (the two cumulative sums run
    in another order) move such an edge by up to ~5e-4 in the spacing
    domain, measured; in CDF units the two inverses agree to float32
    rounding. Where the CDF is steep instead, an edge rounded one ulp apart
    moves the CDF by the slope times that ulp: each new edge is held within
    1e-6 in the spacing domain or in CDF units. Then the port's ``NeuSSampler`` is the chain of these rounds,
    exactly."""
    from nerfstudio_torch.core.rays import RaySamples

    jrb, trb = _bundles(32, 15)
    jrounds, draws = _jax_rounds(jrb, jax.random.PRNGKey(4) if train else None)
    uniform = UniformSampler(64, single_jitter=True)(trb, uniforms=draws[0])
    _assert_same_bins(uniform, jrounds[0])
    pdf = PDFSampler(num_samples=16, include_original=True, single_jitter=True, histogram_padding=1e-5)
    chain = uniform
    for i in range(4):
        inv_s = 64.0 * 2**i
        s = to_torch(_edges(jrounds[i]).astype(np.float32))
        e = uniform.spacing_to_euclidean_fn(s)
        prev = trb.get_ray_samples(bin_starts=e[..., :-1, None], bin_ends=e[..., 1:, None],
                                   spacing_starts=s[..., :-1, None], spacing_ends=s[..., 1:, None],
                                   spacing_to_euclidean_fn=uniform.spacing_to_euclidean_fn)
        jsdf = _sphere_sdf(jnp)(jrounds[i])
        jw, _ = jrounds[i].get_weights_and_transmittance_from_alphas(
            jrs.NeuSSampler._alphas_from_sdf(jrounds[i], jsdf, inv_s))
        sdf = _sphere_sdf(torch)(prev)
        w, _ = RaySamples.get_weights_and_transmittance_from_alphas(NeuSSampler._alphas_from_sdf(prev, sdf, inv_s))
        np.testing.assert_allclose(sdf.numpy(), np.asarray(jsdf), rtol=0, atol=1e-6, err_msg=f"round {i} sdf")
        old = _edges(jrounds[i])
        mid = (old[:, 1:] + old[:, :-1]) / 2  # the CDF's knots lie at the edges; compare at every one
        knots = np.concatenate([old, mid], axis=-1)
        cdf_in = np.abs(_cdf_units(old, w.numpy()[..., 0], 1e-5, knots)
                        - _cdf_units(old, np.asarray(jw)[..., 0], 1e-5, knots))
        assert cdf_in.max() <= 1e-5, (i, cdf_in.max())
        got = pdf(trb, prev, w, uniforms=draws[i + 1])
        want = _edges(jrounds[i + 1])
        edges = _edges(got)
        assert edges.shape == want.shape == (32, 65 + 17 * (i + 1))
        assert all(np.isin(old[r], edges[r]).all() for r in range(32)), f"round {i}: an earlier edge is lost"
        cdf_gap = np.abs(_cdf_units(old, np.asarray(jw)[..., 0], 1e-5, edges)
                         - _cdf_units(old, np.asarray(jw)[..., 0], 1e-5, want))
        gap = np.minimum(cdf_gap, np.abs(edges - want))
        assert gap.max() <= 1e-6, (i, gap.max(), cdf_gap.max(), np.abs(edges - want).max())
        chain = pdf(trb, chain, RaySamples.get_weights_and_transmittance_from_alphas(
            NeuSSampler._alphas_from_sdf(chain, _sphere_sdf(torch)(chain), inv_s))[0], uniforms=draws[i + 1])
    full = NeuSSampler()(trb, _sphere_sdf(torch), uniforms=None if draws[0] is None else SamplerUniforms(None, draws))
    assert full.frustums.starts.shape == (32, 132, 1)
    assert torch.equal(full.spacing_starts, chain.spacing_starts) and torch.equal(full.frustums.ends,
                                                                                  chain.frustums.ends)


def test_neus_sampler_takes_its_sdf_without_a_graph():
    """The four SDF passes feed only stopped bins: they run without a graph
    (an SDF that records one would raise here), and the samples equal the
    ones with a graph."""
    _, trb = _bundles(8, 16)
    seen = []

    def sdf(rs):
        seen.append(torch.is_grad_enabled())
        return _sphere_sdf(torch)(rs)

    got = NeuSSampler(num_samples=8, num_samples_importance=8)(trb, sdf)
    assert seen == [False] * 4
    with pytest.raises(ValueError, match="takes 5 jitters"):
        NeuSSampler()(trb, sdf, uniforms=SamplerUniforms(None, (None,) * 3))
    assert got.frustums.starts.shape == (8, 8 + 4 * 3, 1)


# --------------------------------------------------------------------------
# the SDF field's appearance embedding and numerical gradients


def _field_pair(train, **kw):
    """The JAX SDFField at TINY_FIELD with ``kw`` in the given mode, its
    params (initialised in training mode on samples with cameras, so the
    tree holds the appearance embedding however the field is applied), and
    the port's field with the converted parameters, in the same mode."""
    jfield = JSDFField(num_images=NUM_IMAGES, train=train, **TINY_FIELD, **kw)
    jinit = JSDFField(num_images=NUM_IMAGES, train=True, **TINY_FIELD, **kw)
    params = jax.device_get(jax.jit(jinit.init)(jax.random.PRNGKey(6), _with_cameras(4, 3, 0)[0]))
    field = SDFField(device=CPU, num_images=NUM_IMAGES, **TINY_FIELD, **kw).train(train)
    field.load_state_dict(params_from_jax(params, field))
    return jfield, params, field


def _with_cameras(n_rays, n_samples, seed):
    """``_rays_and_samples`` with a camera index per ray."""
    jsamples, tsamples = _rays_and_samples(n_rays, n_samples, seed)
    cams = np.random.default_rng(seed).integers(0, NUM_IMAGES, (n_rays, 1, 1)).astype(np.int32)
    cams = np.broadcast_to(cams, (n_rays, n_samples, 1)).copy()
    return (dataclasses.replace(jsamples, camera_indices=jnp.asarray(cams)),
            dataclasses.replace(tsamples, camera_indices=to_torch(cams)))


@pytest.mark.parametrize("mode", ["train", "average", "zeros"])
def test_sdf_field_appearance_embedding_matches_jax(mode):
    """The colour net's appearance code (reference :113, :123-124, :137-138,
    :180): the camera's own in training, the mean code at eval under
    ``use_average_appearance_embedding``, zeros otherwise; rgb within 1e-5,
    and in training the embedding's gradient within 1e-4 of its peak
    (only the cameras seen get one)."""
    train = mode == "train"
    jfield, params, field = _field_pair(train, use_appearance_embedding=True, appearance_embedding_dim=6,
                                        use_average_appearance_embedding=mode == "average")
    assert field.embedding_appearance.embedding.weight.shape == (NUM_IMAGES, 6)
    jsamples, tsamples = _with_cameras(16, 8, 17)
    want = jfield.apply(params, jsamples)
    got = field(tsamples)
    np.testing.assert_allclose(got[FieldHeadNames.RGB].detach().numpy(), np.asarray(want[JNames.RGB]), rtol=0,
                               atol=1e-5)
    if train:
        jg = params_from_jax(jax.grad(lambda p: jnp.sum(jfield.apply(p, jsamples)[JNames.RGB]))(params), field)
        got[FieldHeadNames.RGB].sum().backward()
        name = "embedding_appearance.embedding.weight"
        ref = jg[name].numpy()
        np.testing.assert_allclose(field.embedding_appearance.embedding.weight.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        unseen = sorted(set(range(NUM_IMAGES)) - set(np.unique(np.asarray(jsamples.camera_indices)).tolist()))
        assert all(not field.embedding_appearance.embedding.weight.grad[i].any() for i in unseen)


def test_numerical_gradients_match_jax():
    """Central differences over six more geometric passes (reference
    :125-126, :207-227). The quotient (s(x + d) - s(x - d)) / 2d at d =
    1e-4 in float32 carries the rounding of its two SDF values divided by
    2d: ~2^-24 |s| / 2d, i.e. ~3e-4 per ulp of an SDF near 1, and the two
    sides' SDF values differ by several ulps (the products' sum order, the
    softplus' exp). So the SDF at the six offsets is held within 1e-6 of
    JAX's, and each gradient component within the largest such gap over d
    (the quotient's error is at most (|gap(x+d)| + |gap(x-d)|) / 2d);
    normals the same, and the alphas taken on JAX's gradients within
    1e-5. The weights' gradient of a loss
    through them (the eikonal term) within 1e-2 of each parameter's peak:
    its cotangents pass the same 1/2d quotient. The analytic gradient lies
    within 1e-2 of the quotient (a second-order difference at d = 1e-4)."""
    jfield, params, field = _field_pair(True, use_numerical_gradients=True)
    assert jfield.numerical_gradient_delta == NUMERICAL_GRADIENT_DELTA
    jsamples, tsamples = _rays_and_samples(16, 8, 18)
    want = jfield.apply(params, jsamples)
    got = field(tsamples)
    d = NUMERICAL_GRADIENT_DELTA
    offsets = torch.tensor([[d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0], [0, 0, d], [0, 0, -d]])
    pts = (tsamples.frustums.get_positions()[..., None, :] + offsets).reshape(-1, 3)
    tsdf = field.forward_geonetwork(pts)[..., 0].detach().numpy()
    jsdf = np.asarray(jfield.apply(params, jnp.asarray(pts.numpy()), method=lambda m, p: m.forward_geonetwork(p)))
    sdf_gap = float(np.abs(tsdf - jsdf[..., 0]).max())
    assert sdf_gap <= 1e-6, sdf_gap
    for name in (JNames.GRADIENT, JNames.NORMALS):
        np.testing.assert_allclose(got[FieldHeadNames(name.value)].detach().numpy(), np.asarray(want[name]),
                                   rtol=0, atol=sdf_gap / d, err_msg=name.value)
    alpha = field.get_alpha(tsamples, got[FieldHeadNames.SDF], to_torch(want[JNames.GRADIENT]))
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(want[JNames.ALPHA]), rtol=0, atol=1e-5)

    def jloss(p):
        g = jfield.apply(p, jsamples)[JNames.GRADIENT]
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    jg = params_from_jax(jax.device_get(jax.grad(jloss)(params)), field)
    torch.mean((torch.linalg.norm(got[FieldHeadNames.GRADIENT], dim=-1) - 1.0) ** 2).backward()
    for n, p in field.named_parameters():
        ref = jg[n].numpy()
        got_g = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got_g, ref, rtol=0, atol=1e-2 * np.abs(ref).max() + 1e-12, err_msg=n)
    analytic = SDFField(device=CPU, num_images=NUM_IMAGES, **TINY_FIELD)
    analytic.load_state_dict(field.state_dict())
    exact = analytic(tsamples)[FieldHeadNames.GRADIENT].detach()
    diff = (exact - got[FieldHeadNames.GRADIENT].detach()).abs().max()
    assert float(diff) < 1e-2 * float(exact.abs().max())


# --------------------------------------------------------------------------
# the training step and the eval render


def _jax_draws(key, n_rounds=4):
    """The port's ``StepDraws`` of one JAX neus step from ``key``: pixels as
    ``jax_step_draws`` takes them, then from the model's key the sampler's
    (model :125-131, sampler :344-360): the uniform round's jitter, then
    one per upsampling round, (RAYS, 1) each."""
    pixels = jax_step_draws(key, RAYS, NUM_IMAGES, HW, HW).pixels
    _, k_model = jax.random.split(key)
    k_samp, _ = jax.random.split(k_model)
    k0, k = jax.random.split(k_samp)
    jitter = [jax.random.uniform(k0, (RAYS, 1))]
    for _ in range(n_rounds):
        kp, k = jax.random.split(k)
        jitter.append(jax.random.uniform(kp, (RAYS, 1)))
    return StepDraws(pixels, SamplerUniforms(None, tuple(to_torch(u) for u in jitter)))


@pytest.fixture(scope="module")
def world():
    """The JAX side (bench.py's synthetic scene, the tiny plain neus, its
    init, its pipeline with the method's optimizer, a jitted
    loss-and-gradient of its train step) and the port's data manager."""
    from __graft_entry__ import _synthetic_setup
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method

    _, dm, _, _ = _synthetic_setup(hw=HW, n_images=NUM_IMAGES, rays=RAYS, tiny=True)
    jcfg = dataclasses.replace(JNeuSConfig(eval_num_rays_per_chunk=64), **TINY_NEUS)
    jmodel = JNeuS(config=jcfg, num_train_data=NUM_IMAGES, train=True)
    idx, _ = dm.sample_train_batch(jax.random.PRNGKey(0), dm.train_images, num_rays=8)
    params = init_params(
        lambda k: jmodel.init(k, j_rays_from_indices(dm.train_cameras, idx), key=jax.random.PRNGKey(0)), 41)
    jpipe = JPipeline(dm, jmodel, None, tx=build_optimizers(jget_method("neus").optimizers, params))

    def loss_and_grads(params, key, cosine_anneal):
        k_pix, k_model = jax.random.split(key)
        idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

        def loss_fn(p):
            outputs = jmodel.apply(p, j_rays_from_indices(dm.train_cameras, idx), key=k_model,
                                   cosine_anneal=cosine_anneal)
            loss_dict = jmodel.get_loss_dict(outputs, batch, None, p, config=jmodel.config)
            return sum(loss_dict.values()), loss_dict

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    tcams = Cameras.create(np.array(dm.train_cameras.camera_to_worlds), HW * 1.2, HW * 1.2, HW / 2, HW / 2, HW, HW,
                           device=CPU)
    tdm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=RAYS), tcams,
                                 torch.from_numpy(np.array(dm.train_images)), device=CPU)
    return dict(jmodel=jmodel, jcfg=jcfg, params=params, jpipe=jpipe, dm=dm, tdm=tdm,
                loss_and_grads=jax.jit(loss_and_grads))


def _torch_model(train: bool):
    return NeuSModelConfig(eval_num_rays_per_chunk=64, **TINY_NEUS).setup(num_train_data=NUM_IMAGES,
                                                                          device=CPU).train(train)


STEP = 300


@pytest.fixture(scope="module")
def run(world):
    """Two steps (STEP, STEP+1) on both sides from the same params, JAX's
    draws handed in; the first step's gradients at identical params."""
    jmodel, jcfg, jpipe, dm, tdm = (world[k] for k in ("jmodel", "jcfg", "jpipe", "dm", "tdm"))
    jstate = jpipe.init_state(jax.random.PRNGKey(0), params=world["params"])
    model = _torch_model(train=True)
    state_dict, aux, _ = train_state_from_jax(jstate, model)
    assert aux is None
    model.load_state_dict(state_dict)
    tstate = TrainState(PerGroupAdam(neus_optimizers(), model), step=STEP)
    tpipe = VanillaPipeline(tdm, model)
    records = []
    for i, step in enumerate(range(STEP, STEP + 2)):
        k_step = jax.random.PRNGKey(300 + i)
        kwargs = JNeuS.step_kwargs(step, jcfg)
        assert NeuSModel.step_kwargs(step, model.config) == kwargs
        rec = dict(step=step)
        if i == 0:
            (_, rec["j_terms"]), rec["j_grads"] = world["loss_and_grads"](jstate.params, k_step,
                                                                          kwargs["cosine_anneal"])
        hash_grid.reset_launch_counts()
        jstate, jmetrics = jpipe.train_step(jstate, dm.train_images, k_step, **kwargs)
        tstate.step = step
        tmetrics = tpipe.train_step(tstate, draws=_jax_draws(k_step), **kwargs)
        rec["launches"] = dict(hash_grid.launch_counts)
        rec["j_metrics"] = {k: float(v) for k, v in jmetrics.items()}
        rec["t_metrics"] = {k: float(v) for k, v in tmetrics.items()}
        if i == 0:
            rec["t_grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        records.append(rec)
    return records, jax.device_get(jstate.params), model


def test_step_losses_match_jax(run):
    """rgb, eikonal, loss and psnr at both steps within 1e-4: the SDF field
    is float32 on both sides and the samples agree to BIN_TOL; no kernel
    launches on this path."""
    records, _, _ = run
    for rec in records:
        assert rec["launches"] == NO_HASH_LAUNCHES
        j, t = rec["j_metrics"], rec["t_metrics"]
        assert set(t) == set(j) == {"loss", "rgb_loss", "eikonal_loss", "psnr"}, (sorted(t), sorted(j))
        for k in t:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-8, err_msg=f"step {rec['step']} {k}")


def test_first_step_gradients_match_jax(run):
    """The first step's gradients at identical parameters, each within a
    share of its parameter's peak: 1e-4, but 1e-2 for the two layers that
    read the positional encoding (the eikonal term's second derivative
    carries the top frequency's (2 pi 32)^2, which amplifies the samples'
    float32-ulp differences), as in test_torch_neus."""
    records, _, model = run
    rec = records[0]
    jg = params_from_jax(rec["j_grads"], model)
    pe_fed = {f"field.glin.{i}.weight" for i in (0,) + model.field.skips}
    for n, ref in jg.items():
        ref = ref.numpy()
        got = rec["t_grads"][n].numpy()
        rel = 1e-2 if n in pe_fed else 1e-4
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=n)


def test_parameters_after_two_adam_steps(run):
    """Parameters after the two steps, in units of the field's learning rate
    at the second (the first is 0 in the 5000-step warm-up, the second
    5e-4 / 5000): at most 2 rates per entry and a mean of 0.02 per tensor,
    as test_torch_neus holds neus-facto's (Adam's first steps move every
    entry with a gradient by about the rate, whatever its size)."""
    _, jparams, model = run
    jp = params_from_jax(jparams, model)
    lr = 5e-4 / 5000
    for n, p in model.named_parameters():
        gap = np.abs(p.detach().numpy() - jp[n].numpy()) / lr
        assert gap.max() <= 2.0 and gap.mean() <= 0.02, (n, gap.max(), gap.mean())


def test_eval_render_matches_jax(world):
    """A 16x16 eval render in 64-ray chunks from the JAX init (the sampler
    at its eval midpoints): rgb, accumulation, expected depth and normals
    within 1e-3."""
    jcfg, params = world["jcfg"], world["params"]
    jeval = JNeuS(config=jcfg, num_train_data=NUM_IMAGES, train=False)
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


def test_near_far_collider_route():
    """Without the sphere collider the rays take the config's planes."""
    model = NeuSModelConfig(use_sphere_collider=False, **TINY_NEUS).setup(device=CPU).eval()
    _, trb = _bundles(4, 19)
    trb = dataclasses.replace(trb, nears=None, fars=None)
    seen = []
    sampler = ray_samplers.NeuSSampler.__call__

    def spy(self, ray_bundle, sdf_fn, **kw):
        seen.append((float(ray_bundle.nears.min()), float(ray_bundle.fars.max())))
        return sampler(self, ray_bundle, sdf_fn, **kw)

    ray_samplers.NeuSSampler.__call__ = spy
    try:
        with torch.no_grad():
            out = model(trb)
    finally:
        ray_samplers.NeuSSampler.__call__ = sampler
    assert seen == [(pytest.approx(0.05), pytest.approx(4.0))] and out["rgb"].shape == (4, 3)


# --------------------------------------------------------------------------
# the method config and the gate runner's route


@pytest.mark.parametrize("method", ["neus", "nerfacto-big", "nerfacto-huge"])
def test_method_config_matches_jax(method):
    """``get_method`` returns the shipped config: every field the two share
    equal, the trainer, datamanager and dataparser with exactly JAX's
    fields, and the optimizer groups' rates, eps and schedules equal."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_torch.configs.method_configs import get_method

    jcfg, tcfg = jget_method(method), get_method(method)
    j, t = _leaves(jcfg), _leaves(tcfg)
    shared = set(j) & set(t)
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    for part in ("trainer.", "datamanager.", "dataparser."):
        assert {k for k in t if k.startswith(part)} == {k for k in j if k.startswith(part)}, part
    assert set(t) - set(j) <= {k for k in t if k.startswith(("machine.", "model."))}
    assert set(tcfg.optimizers) == set(jcfg.optimizers)
    for g, jo in jcfg.optimizers.items():
        to = tcfg.optimizers[g]
        assert (to["optimizer"].lr, to["optimizer"].eps) == (jo["optimizer"].lr, jo["optimizer"].eps), g
        js, ts = jo["scheduler"], to["scheduler"]
        assert type(ts).__name__ == type(js).__name__, g
        for f in dataclasses.fields(ts):
            assert getattr(ts, f.name) == getattr(js, f.name), (g, f.name)


def test_gate_routes_neus_through_the_blender_parser(tmp_path):
    """``scripts.gate neus`` on a ``basic`` scene dir trains the ``blender``
    scene beside it through the Blender parser with ``alpha_color=None``
    (the ground truth RGBA, blended over neus's black), evaluates every test
    view and stands beside ``benchmarks/gate_neus_blender.json``; the gate
    steps are the JAX runner's (tools/run_gate_matrix.py:29-50)."""
    import subprocess
    import sys
    from pathlib import Path

    from nerfstudio_torch.data.dataparsers.blender_dataparser import Blender, BlenderDataParserConfig
    from nerfstudio_torch.scripts import gate

    repo = Path(__file__).resolve().parent.parent
    for scene in ("basic", "blender"):
        subprocess.run([sys.executable, str(repo / "tools" / "make_synthetic_dataset.py"), str(tmp_path / scene),
                        "--scene", scene, "--hw", "16", "--n-train", "4", "--n-test", "2", "--n-points", "100"],
                       check=True, capture_output=True, timeout=300)
    assert {m: gate.GATE_STEPS[m] for m in ("neus", "nerfacto-big", "nerfacto-huge")} == {
        "neus": 12000, "nerfacto-big": 3000, "nerfacto-huge": 1500}
    overrides = ["--machine.device_type", "cpu", "--model.num_layers", "3", "--model.hidden_dim", "16",
                 "--model.geo_feat_dim", "4", "--model.hidden_dim_color", "8", "--model.num_samples", "8",
                 "--model.num_samples_importance", "8", "--datamanager.train_num_rays_per_batch", "16"]
    result, run = gate.run_gate("neus", tmp_path / "basic", tmp_path / "runs", 2, overrides=overrides)
    dm = run["pipeline"].datamanager
    assert result["scene"] == "blender" and result["eval_config"]["eval_chunk"] == 1024
    record = json.loads((repo / "benchmarks" / "gate_neus_blender.json").read_text())["metrics"]
    assert result["jax_record"] == {"psnr": record["psnr"], "ssim": record["ssim"]}
    train_out = dm.train_dataset._dataparser_outputs
    want = Blender(BlenderDataParserConfig(data=tmp_path / "blender", alpha_color=None)).get_dataparser_outputs("train")
    assert train_out.alpha_color is None and train_out.image_filenames == want.image_filenames
    # the train images keep their alpha (the loss blends them over black);
    # the eval views are premultiplied onto black, as the reference's are
    assert dm.num_channels == 4 and len(dm.eval_dataset) == 2
    rgba = dm.eval_dataset.get_numpy_image(0).astype(np.float32) / 255.0
    np.testing.assert_array_equal(dm.eval_image(0)[1]["image"], rgba[..., :3] * rgba[..., 3:])
    assert np.isfinite(result["final_loss"])
