"""Parity of the port's cameras, collider, samplers, contraction, occupancy
probe and renderers with the JAX reference on identical float32 inputs.

Tolerance rtol 1e-5, atol 1e-6 throughout: the two packages run the same
float32 operations, and only reduction order (sums, cumsums, the 3-term
rotation) differs, which moves results by a few ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, orbit_c2w, sphere_grid_binary, to_torch
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.core.rays import render_weights_from_density as j_weights
from nerfstudio_tpu.data.scene_box import SceneBox as JSceneBox
from nerfstudio_tpu.field_components.spatial_distortions import SceneContraction as JContraction
from nerfstudio_tpu.model_components import ray_samplers as jrs
from nerfstudio_tpu.model_components import renderers as jrend
from nerfstudio_tpu.model_components.scene_colliders import NearFarCollider as JCollider
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.core.rays import RayBundle, render_weights_from_density
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.field_components.spatial_distortions import SceneContraction
from nerfstudio_torch.model_components import ray_samplers as trs
from nerfstudio_torch.model_components import renderers as trend
from nerfstudio_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_torch.utils.convert import occupancy_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
# Where a result passes through an ill-conditioned step, the few-ulp gap of
# the PDF's cumsum (torch's CPU cumsum accumulates in float64, XLA's
# reduce_window sums float32 in its own order) is amplified:
# * the disparity map 1/(2 - 2s) past distance 1 multiplies a spacing-domain
#   difference by 1/(1 - s), up to ~2000 at the far plane (measured 1.5e-5
#   relative in euclidean PDF bins, 4e-5 in proposal weights built on them);
# * inverting a CDF through bins of weight 1e-3 (empty occupancy probes)
#   divides by a tiny CDF step (measured 2.4e-5 relative in spacing bins).
FAR = dict(rtol=1e-4, atol=1e-6)


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), **(tol or TOL))


def _cameras(hw=12, n=3):
    c2w = orbit_c2w(n)
    args = (c2w, hw * 1.1, hw * 0.9, hw / 2 + 0.3, hw / 2 - 0.2, hw, hw + 2)
    return JCameras(*args), Cameras.create(*args, device=CPU)


def _bundles(num_rays=64, seed=0):
    """Matching ray bundles with nears/fars from the eval collider."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (num_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    area = rng.uniform(1e-6, 1e-4, (num_rays, 1)).astype(np.float32)
    jrb = JCollider(0.05, 1000.0)(JRayBundle(origins=o, directions=d, pixel_area=area), training=False)
    trb = NearFarCollider(0.05, 1000.0)(
        RayBundle(origins=to_torch(o), directions=to_torch(d), pixel_area=to_torch(area)), training=False
    )
    return jrb, trb


@pytest.mark.parametrize("idx", [0, 2])
def test_generate_rays_perspective(idx):
    """Pixel offset 0.5, the OpenCV->OpenGL flip and the finite-difference
    pixel area, for a non-square camera with an off-centre principal point."""
    jc, tc = _cameras()
    jrb = jc.generate_rays(camera_indices=idx)
    trb = tc.generate_rays(camera_indices=idx)
    assert trb.shape == tuple(jrb.shape)
    close(trb.origins, jrb.origins)
    close(trb.directions, jrb.directions)
    close(trb.pixel_area, jrb.pixel_area)
    close(trb.metadata["directions_norm"], jrb.metadata["directions_norm"])
    np.testing.assert_array_equal(trb.camera_indices.numpy(), np.asarray(jrb.camera_indices))
    close(tc.get_image_coords(index=idx), jc.get_image_coords(index=(idx,)))


def test_near_far_collider_eval():
    jrb, trb = _bundles()
    close(trb.nears, jrb.nears)
    close(trb.fars, jrb.fars)


def test_scene_contraction_and_normalization():
    rng = np.random.default_rng(1)
    pts = (rng.normal(0, 2, (500, 3)) * rng.uniform(0, 3, (500, 1))).astype(np.float32)
    close(SceneContraction(order="inf")(to_torch(pts)), JContraction(order="inf")(jnp.asarray(pts)))
    close(SceneContraction()(to_torch(pts)), JContraction()(jnp.asarray(pts)))
    aabb = np.array([[-1.5, -1, -2], [1, 2, 0.5]], np.float32)
    close(SceneBox.get_normalized_positions(to_torch(pts), to_torch(aabb)),
          JSceneBox.get_normalized_positions(jnp.asarray(pts), jnp.asarray(aabb)))


def test_linspace_is_bit_exact():
    for start, stop, num in [(0.0, 1.0, 17), (0.0, 1.0 - 1 / 33, 33), (0.0, 1.0, 129)]:
        np.testing.assert_array_equal(trs.linspace(start, stop, num).numpy(), np.asarray(jnp.linspace(start, stop, num)))


@pytest.mark.parametrize("kind", ["uniform", "piecewise"])
def test_spaced_samplers_eval(kind):
    jrb, trb = _bundles()
    jmake = jrs.UniformSampler if kind == "uniform" else jrs.UniformLinDispPiecewiseSampler
    tmake = trs.UniformSampler if kind == "uniform" else trs.UniformLinDispPiecewiseSampler
    js = jmake(16)(jrb, key=None)
    ts = tmake(16)(trb)
    close(ts.frustums.starts, js.frustums.starts)
    close(ts.frustums.ends, js.frustums.ends)
    close(ts.spacing_starts, js.spacing_starts)
    close(ts.deltas, js.deltas)
    close(ts.frustums.get_positions(), js.frustums.get_positions())
    s = np.linspace(0.0, 1.0, 7, dtype=np.float32)[None].repeat(64, 0)
    close(ts.spacing_to_euclidean_fn(to_torch(s)), js.spacing_to_euclidean_fn(jnp.asarray(s)))


@pytest.mark.parametrize("single_jitter", [True, False])
def test_sampler_jitter_is_injected_by_generator(single_jitter):
    """Spaced and PDF samplers draw their jitter from the generator given,
    reproducibly, and stay on the midpoints without one (the eval path)."""
    _, trb = _bundles()
    spaced = trs.UniformLinDispPiecewiseSampler(8, single_jitter=single_jitter)
    pdf = trs.PDFSampler(6, single_jitter=single_jitter)
    w = torch.rand(64, 8, 1, generator=torch.Generator().manual_seed(0))

    def run(gen):
        s0 = spaced(trb, generator=gen)
        return s0.frustums.starts, pdf(trb, s0, w, generator=gen).spacing_starts

    a, b, c = run(torch.Generator().manual_seed(3)), run(torch.Generator().manual_seed(3)), run(None)
    for x, y, z in zip(a, b, c):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert not torch.equal(x, z)


def test_pdf_sampler_eval():
    """Inverse-CDF midpoints; the comparison-count searchsorted of the
    reference is torch.searchsorted(side='left')."""
    jrb, trb = _bundles()
    js0 = jrs.UniformLinDispPiecewiseSampler(24)(jrb, key=None)
    ts0 = trs.UniformLinDispPiecewiseSampler(24)(trb)
    rng = np.random.default_rng(2)
    w = (rng.uniform(0, 1, (64, 24, 1)) ** 4).astype(np.float32)
    w[:4] = 0.0  # degenerate histograms take the padding guard
    js = jrs.PDFSampler(12)(jrb, js0, jnp.asarray(w), key=None)
    ts = trs.PDFSampler(12)(trb, ts0, to_torch(w))
    close(ts.spacing_starts, js.spacing_starts)
    close(ts.spacing_ends, js.spacing_ends)
    close(ts.frustums.starts, js.frustums.starts, **FAR)
    close(ts.frustums.ends, js.frustums.ends, **FAR)
    # on identical spacing-domain inputs the euclidean map agrees within TOL
    s = np.asarray(js.spacing_starts)[..., 0]
    close(ts.spacing_to_euclidean_fn(to_torch(s)), js.frustums.starts[..., 0])


def test_render_weights_and_renderers():
    """Compositing weights, last-sample rgb, median and expected depth,
    accumulation. The expected depth clips to the min/max over the whole
    batch, so rays here span very different depth ranges."""
    jrb, trb = _bundles()
    js = jrs.UniformLinDispPiecewiseSampler(16)(jrb, key=None)
    ts = trs.UniformLinDispPiecewiseSampler(16)(trb)
    rng = np.random.default_rng(3)
    dens = (rng.uniform(0, 2, (64, 16, 1)) ** 3).astype(np.float32)
    rgb = rng.uniform(0, 1, (64, 16, 3)).astype(np.float32)
    jw = j_weights(jnp.asarray(dens), js.deltas)
    tw = render_weights_from_density(to_torch(dens), ts.deltas)
    close(tw, jw)
    close(trend.render_rgb(to_torch(rgb), tw, background_color="last_sample"),
          jrend.render_rgb(jnp.asarray(rgb), jw, background_color="last_sample"))
    close(trend.render_rgb(to_torch(rgb), tw, background_color="white"),
          jrend.render_rgb(jnp.asarray(rgb), jw, background_color="white"))
    close(trend.render_accumulation(tw), jrend.render_accumulation(jw))
    close(trend.render_depth(tw, ts, "median"), jrend.render_depth(jw, js, "median"))
    close(trend.render_depth(tw, ts, "expected"), jrend.render_depth(jw, js, "expected"))


def test_expected_depth_clips_over_the_whole_batch():
    """Chunking hazard: a ray whose own range is [1, 2] is not clipped to it
    when another ray of the batch reaches further."""
    starts = torch.tensor([[1.0, 1.5], [0.2, 0.4]])[..., None]
    ends = torch.tensor([[1.5, 2.0], [0.4, 9.0]])[..., None]
    from nerfstudio_torch.core.rays import Frustums, RaySamples

    zeros = torch.zeros(2, 2, 3)
    rs = RaySamples(frustums=Frustums(zeros, zeros, starts, ends, torch.ones_like(starts)))
    w = torch.tensor([[0.0, 0.0], [0.0, 0.0]])[..., None]
    w[0, 1] = 1e-12  # normalised mean of the far midpoint, pulled towards 0 by eps
    depth = trend.render_depth(w, rs, "expected")
    assert depth[0, 0] == pytest.approx(0.3)  # ray 1's first midpoint, not ray 0's own 1.25
    w2 = torch.tensor([[0.0, 1.0], [0.0, 0.0]])[..., None]
    assert trend.render_depth(w2, rs, "expected")[0, 0] == pytest.approx(1.75)


def test_occupancy_probe_and_conversion():
    """Flat index lookup with the reference's border clamping, on a grid
    converted from the JAX state (its row-packed views are checked)."""
    res = 16
    binary = sphere_grid_binary(res)
    jgrid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res)
    jgrid = jgrid.replace(binary=jnp.asarray(binary), binary_rows=jocc._pack_rows(jnp.asarray(binary), res))
    tgrid = occupancy_from_jax(jgrid)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.2, 1.2, (4000, 3)).astype(np.float32)
    pts[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [-1, 2, 0.5], [1 / 16, 2 / 16, 15 / 16], [0.999, 0.001, 1.0], [2, 2, 2], [-3, -3, -3]]
    from nerfstudio_torch.ops.occupancy import probe_occupancy

    close(probe_occupancy(tgrid, to_torch(pts)), jocc.probe_occupancy(jgrid, jnp.asarray(pts)), rtol=0, atol=0)
    bad = jgrid.replace(binary_rows=jgrid.binary_rows.at[0, 0].set(0.5))
    with pytest.raises(ValueError):
        occupancy_from_jax(bad)


@pytest.mark.parametrize("probes", [True, False], ids=["occupancy_probes", "piecewise_first_round"])
def test_proposal_network_sampler(probes):
    """Occupancy probes (or the piecewise initial sampler) -> PDF -> one
    proposal round -> PDF, with the same analytic density function in both
    packages standing in for the net."""
    jrb, trb = _bundles(num_rays=48, seed=5)
    res = 16
    binary = sphere_grid_binary(res, 0.35)
    jgrid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res)
    jgrid = jgrid.replace(binary=jnp.asarray(binary), binary_rows=jocc._pack_rows(jnp.asarray(binary), res))
    tgrid = occupancy_from_jax(jgrid)
    from nerfstudio_torch.ops.occupancy import probe_occupancy

    def jweights(samples):
        pos01 = (JContraction(order="inf")(samples.frustums.get_positions()) + 2.0) / 4.0
        return jnp.where(jocc.probe_occupancy(jgrid, pos01) > 0.5, 1.0, 1e-3)[..., None]

    def tweights(samples):
        pos01 = (SceneContraction(order="inf")(samples.frustums.get_positions()) + 2.0) / 4.0
        return torch.where(probe_occupancy(tgrid, pos01) > 0.5, 1.0, 1e-3)[..., None]

    def jdens(p):
        return 5.0 * jnp.exp(-jnp.sum(p * p, axis=-1, keepdims=True))

    def tdens(p):
        return 5.0 * torch.exp(-torch.sum(p * p, dim=-1, keepdim=True))

    kw = dict(num_proposal_samples_per_ray=(12,), num_nerf_samples_per_ray=8,
              num_proposal_network_iterations=1, num_initial_probes=16)
    if not probes:
        jweights = tweights = None
    @jax.jit
    def jax_sampler(rb):  # one compile instead of an op-by-op run
        js, jwl, jsl = jrs.ProposalNetworkSampler(initial_weights_fn=jweights, **kw)(rb, [jdens], key=None)
        return jwl[0], jsl[0].spacing_starts, jsl[0].frustums.starts, js.spacing_starts, js.frustums.starts, js.frustums.ends

    ref = jax_sampler(jrb)
    ts, twl, tsl = trs.ProposalNetworkSampler(initial_weights_fn=tweights, **kw)(trb, [tdens])
    got = (twl[0], tsl[0].spacing_starts, tsl[0].frustums.starts, ts.spacing_starts, ts.frustums.starts, ts.frustums.ends)
    for g, r in zip(got, ref):
        close(g, r, **FAR)
