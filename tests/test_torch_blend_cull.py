"""K6 forward's culled design: the box predicate's plain PyTorch twin
(``rasterize._cull_extents``, ``_warp_culled``) and what the design rests on.

* The box is conservative: for every (8x4 warp rectangle, gaussian) pair it
  culls, no pixel of the rectangle has float32 ``sigma >= 0 and alpha >
  1/255`` as the twin evaluates them, on K4-twin projections of random
  gaussians and on adversarial conics (thin, rotated by 45 degrees,
  opacity within ulps of 1/255, determinant near 0 or <= 0, non-finite).
* The twin blend with each warp's culled entries dropped is bit-equal to
  the twin on ``dense_scene`` (test_torch_gsplat_rasterize.py).
* A gaussian with a NaN or infinite conic or opacity is skipped by the
  reference's mask; the twin does the same (the kernels follow it since
  the culled design: a NaN sigma or alpha fails the mask).

The kernels run only on the card: the tests that launch them take the
``cuda_device`` fixture and skip here; chip_smoke.py checks the same."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (a fixture)
from test_torch_gsplat_rasterize import BINNING, _jax_raster, _scene, _t, dense_scene  # noqa: F401
from nerfstudio_torch.ops.gsplat import _cuda as sc
from nerfstudio_torch.ops.gsplat import projection as tproj
from nerfstudio_torch.ops.gsplat import rasterize as tras

K_MIN = np.float32(1.0 / 255.0)


def _passes(pix, means2d, conics, opac):
    """(C, 256, N) bool: the reference's mask (``_blend_tiles``), float32 op
    for op: sigma >= 0 and min(o exp(-sigma), 0.999) > 1/255."""
    d = pix[:, :, None, :] - means2d[None, None, :, :]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    sigma = 0.5 * (a * (d[..., 0] * d[..., 0]) + c * (d[..., 1] * d[..., 1])) + b * d[..., 0] * d[..., 1]
    alpha = torch.minimum(opac * torch.exp(-sigma), sigma.new_tensor(0.999))
    return (sigma >= 0) & (alpha > 1.0 / 255.0)


def _culled_and_passing(means2d, conics, opac, tiles_x, tiles_y):
    """Every gaussian against every warp rectangle of a tiles_x x tiles_y
    image: (culled (C, 8, N), passes (C, 256, N))."""
    n = means2d.shape[0]
    tiles = torch.arange(tiles_x * tiles_y)
    gids = torch.arange(n)[None, :].expand(tiles.shape[0], n)
    culled = tras._warp_culled(means2d, tras._cull_extents(means2d, conics, opac), gids, tiles, tiles_x)
    return culled, _passes(tras._pixel_centers(tiles, tiles_x), means2d, conics, opac)


def _per_pixel(culled):
    """(C, 8, N) per warp -> (C, 256, N) per pixel of the tile."""
    warp_of_pixel = torch.empty(256, dtype=torch.int64)
    warp_of_pixel[tras.warp_pixels()] = torch.arange(8)[:, None]
    return culled[:, warp_of_pixel, :]


def _assert_conservative(culled, passes):
    wrong = _per_pixel(culled) & passes
    assert not bool(wrong.any()), f"{int(wrong.sum())} culled (pixel, gaussian) pairs pass the mask"


def _k4_twin_scene(n, w, h, seed):
    """Random gaussians projected by the port's K4 twin: means2d, conics,
    opacities (uniform in [0.003, 1), some below 1/255) of the valid ones."""
    rng = np.random.default_rng(seed)
    means = torch.from_numpy(rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    scales = torch.from_numpy(np.exp(rng.uniform(-4.5, -1.5, (n, 3))).astype(np.float32))
    quats = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    pos = np.array([2.5, 0.3, 1.2])
    fwd = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    c2w = torch.from_numpy(np.stack([right, np.cross(fwd, right), fwd, pos], -1).astype(np.float32))
    out = tproj._project_twin(means, scales, quats, tproj.get_viewmat(c2w), 1.2 * w, 1.2 * w, w / 2, h / 2, w, h,
                              0.01, 0.3, False)
    m2, conics, valid = out[0], out[2], out[4]
    opac = torch.from_numpy(rng.uniform(0.003, 1.0, n).astype(np.float32))
    return m2[valid], conics[valid], opac[valid]


@pytest.mark.parametrize("seed", [0, 1])
def test_box_is_conservative_on_projected_gaussians(seed):
    w, h = 64, 48
    m2, conics, opac = _k4_twin_scene(4000, w, h, seed)
    culled, passes = _culled_and_passing(m2, conics, opac, w // 16, h // 16)
    _assert_conservative(culled, passes)
    # not vacuous: most pairs culled, and some culled pairs pass at a pixel
    # of a neighbouring warp of the same tile
    share = float(culled.float().mean())
    assert 0.5 < share < 1.0, share
    near = culled & passes.any(dim=1, keepdim=True)
    assert bool(near.any())


def _conic_of(cov):
    """float64 (N, 2, 2) covariances -> float32 conics (a, b, c) of their inverses."""
    inv = np.linalg.inv(cov)
    return np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1).astype(np.float32)


def _rotated(n, rng, major, minor, angle):
    th = np.full(n, angle) if angle is not None else rng.uniform(0, np.pi, n)
    r = np.stack([np.stack([np.cos(th), -np.sin(th)], -1), np.stack([np.sin(th), np.cos(th)], -1)], -2)
    d = np.zeros((n, 2, 2))
    d[:, 0, 0], d[:, 1, 1] = major, minor
    return _conic_of(r @ d @ np.transpose(r, (0, 2, 1)))


def _adversarial(case, n, rng):
    """(conics, opacities) of one adversarial case, float32."""
    opac = rng.uniform(0.05, 1.0, n).astype(np.float32)
    if case == "thin":
        # as thin as K4's 0.3 px^2 dilation leaves a gaussian, and thinner
        conics = _rotated(n, rng, rng.uniform(20, 300, n) ** 2, rng.uniform(0.2, 0.8, n) ** 2, None)
    elif case == "rotated_45":
        conics = _rotated(n, rng, rng.uniform(5, 60, n) ** 2, rng.uniform(0.1, 2, n) ** 2, np.pi / 4)
    elif case == "opacity_near_1_255":
        conics = _rotated(n, rng, rng.uniform(1, 10, n) ** 2, rng.uniform(1, 10, n) ** 2, None)
        steps = rng.integers(-3, 4, n)
        opac = np.array([np.float32(K_MIN) for _ in range(n)], np.float32)
        for i, k in enumerate(steps):
            for _ in range(abs(k)):
                opac[i] = np.nextafter(opac[i], np.float32(1 if k > 0 else 0))
        opac[: n // 4] = np.float32(1.0)  # the tightest sigma* near a bright one, for contrast
    elif case == "det_near_0":
        a = rng.uniform(0.01, 4, n).astype(np.float32)
        c = rng.uniform(0.01, 4, n).astype(np.float32)
        rho = 1.0 - 10.0 ** rng.uniform(-8, -2, n)
        b = (np.sqrt(a.astype(np.float64) * c) * rho * rng.choice([-1, 1], n)).astype(np.float32)
        conics = np.stack([a, b, c], -1)
    elif case == "det_not_positive":
        a = rng.uniform(-2, 2, n).astype(np.float32)
        c = rng.uniform(-2, 2, n).astype(np.float32)
        b = (np.sqrt(np.abs(a.astype(np.float64) * c)) * rng.uniform(1.0, 1.5, n)).astype(np.float32)
        conics = np.stack([a, b, c], -1)
    else:  # non_finite
        conics = _rotated(n, rng, rng.uniform(1, 10, n) ** 2, rng.uniform(1, 10, n) ** 2, None)
        bad = [np.nan, np.inf, -np.inf]
        for i in range(n):
            if i % 4 < 3:
                conics[i, i % 3] = bad[(i // 4) % 3]
            else:
                opac[i] = bad[(i // 4) % 3]
    return conics, opac


@pytest.mark.parametrize("case", ["thin", "rotated_45", "opacity_near_1_255", "det_near_0", "det_not_positive",
                                  "non_finite"])
def test_box_is_conservative_on_adversarial_conics(case):
    rng = np.random.default_rng(["thin", "rotated_45", "opacity_near_1_255", "det_near_0", "det_not_positive",
                                 "non_finite"].index(case) + 10)
    n, w, h = 600, 64, 48
    conics, opac = _adversarial(case, n, rng)
    m2 = rng.uniform(-8, [w + 8, h + 8], (n, 2)).astype(np.float32)
    m2[: n // 3] = np.round(m2[: n // 3]) + rng.choice([0.0, 0.5], (n // 3, 2))  # on pixel edges and centres
    m2, conics, opac = _t(m2, conics, opac)
    culled, passes = _culled_and_passing(m2, conics, opac, w // 16, h // 16)
    _assert_conservative(culled, passes)
    ex, ey = tras._cull_extents(m2, conics, opac)
    none = torch.isnan(ex) & torch.isnan(ey)
    if case in ("det_not_positive", "non_finite"):
        # no box: never culled
        assert bool(none.all()) and not bool(culled.any())
    elif case == "opacity_near_1_255":
        # at or below 1/255 the box is empty (culled everywhere)
        low = opac <= torch.tensor(K_MIN)
        assert bool(low.any()) and bool(culled[:, :, low].all())
        assert not bool(passes[:, :, low].any())
        assert not bool(culled[:, :, ~low].all())
    elif case == "det_near_0":
        # the thinnest get no box, the rest are culled somewhere
        assert bool(none.any()) and bool((~none).any()) and bool(culled.any())
    else:
        # a box for most (the thinnest along a diagonal get none), culled somewhere
        assert float(none.float().mean()) < 0.5 and bool(culled.any())


def test_culled_twin_is_bit_equal_on_the_dense_scene(dense_scene):
    m2, conics, ch, opac, bins, w, h = dense_scene
    want = tras._blend_twin(m2, conics, ch, opac, bins, w, h)
    got = tras._blend_twin(m2, conics, ch, opac, bins, w, h, culled=True)
    assert torch.equal(got, want)
    # not vacuous: the warps drop most of their tiles' entries
    live = int(bins.counts.sum())
    tiles = torch.repeat_interleave(torch.arange(bins.counts.shape[0]), bins.counts.long())
    entry_ids = bins.ids[:live].long()[:, None]
    ext = tras._cull_extents(m2, conics, opac)
    skipped = tras._warp_culled(m2, ext, entry_ids, tiles, bins.tiles_x)  # (live, 8, 1)
    assert float(skipped.float().mean()) > 0.3


def test_twin_skips_non_finite_entries_as_the_reference_does(blend_scene_non_finite):
    """NaN or infinite conics and opacities on some gaussians: the
    reference's mask (sigma >= 0 and alpha > 1/255, false for NaN) skips
    them, and so does the twin; values within 2e-4, as in
    test_blend_values_match_jax."""
    w, h, scene = blend_scene_non_finite
    rgb, alpha, _ = (np.asarray(x) for x in _jax_raster(w, h)(*(jnp.asarray(x) for x in scene)))
    trgb, talpha, _ = (x.numpy() for x in tras.rasterize(*_t(*scene), width=w, height=h, **BINNING))
    assert np.isfinite(rgb).all() and np.isfinite(trgb).all()
    assert np.abs(trgb - rgb).max() <= 2e-4 and np.abs(talpha - alpha).max() <= 2e-4


@pytest.fixture(scope="module")
def blend_scene_non_finite():
    """test_torch_gsplat_rasterize's blend scene with non-finite conics or
    opacities on 60 of its valid gaussians."""
    w, h, n = 64, 48, 1200
    m2, conics, depths, radii, valid = _scene(n, w, h, seed=3, log_scale=(-3.0, -1.5))
    conics = conics.copy()
    rng = np.random.default_rng(4)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    bad = np.nonzero(valid)[0][::10][:60]
    for i, g in enumerate(bad):
        if i % 4 < 3:
            conics[g, i % 3] = [np.nan, np.inf][i % 2]
        else:
            opac[g] = [np.nan, np.inf][i % 2]
    return w, h, (m2, conics, colors, opac, depths, radii, valid)


def test_blend_kernel_rejects_an_unknown_design(dense_scene):
    m2, conics, ch, opac, bins, w, h = dense_scene
    sc.reset_launch_counts()
    with pytest.raises(ValueError, match="is not one of"):
        tras._blend_kernel(m2, conics, ch, opac, bins, w, h, _design="per-warp")
    assert all(v == 0 for v in sc.launch_counts.values()) and "blend_saturating_per_pixel" in sc.launch_counts
    assert tras.BLEND_FWD_DESIGNS == ("culled", "per_pixel")


def _on(device, m2, conics, ch, opac, bins):
    dev = lambda x: x.to(device)  # noqa: E731
    return (*map(dev, (m2, conics, ch, opac)),
            tras.TileBins(*map(dev, (bins.packed, bins.ids, bins.starts, bins.counts)), bins.tiles_x, bins.tiles_y,
                          bins.depth_bits, bins.id_bits))


def test_blend_fwd_designs_are_bit_equal_on_the_card(cuda_device, dense_scene):
    """Both designs' out, T and last bit-equal, and within 2e-4 of each
    channel's peak of the twin (chip_smoke.py's K6_FWD_REL)."""
    m2, conics, ch, opac, bins, w, h = dense_scene
    args = _on(cuda_device, m2, conics, ch, opac, bins)
    got = {d: tras._blend_kernel(*args, w, h, _design=d) for d in tras.BLEND_FWD_DESIGNS}
    torch.cuda.synchronize()
    for a, b in zip(got["culled"], got["per_pixel"]):
        assert torch.equal(a, b)
    want = tras._blend_twin(*args, w, h)
    peak = args[2].abs().amax(dim=0).clamp_min(1.0)
    assert float(((got["culled"][0] - want).abs().amax(dim=(0, 1)) / peak).max()) <= 2e-4


def test_blend_fwd_skips_non_finite_entries_on_the_card(cuda_device, dense_scene):
    """NaN and infinite conics and opacities: both designs skip those
    entries, as the reference and the twin do (before the culled design the
    kernel blended an entry with a NaN sigma or alpha at alpha 0.999)."""
    m2, conics, ch, opac, bins, w, h = dense_scene
    conics, opac = conics.clone(), opac.clone()
    ids = bins.ids[: int(bins.counts.sum())].long().unique()[::7]
    for i, g in enumerate(ids.tolist()):
        if i % 4 < 3:
            conics[g, i % 3] = [float("nan"), float("inf")][i % 2]
        else:
            opac[g] = [float("nan"), float("inf")][i % 2]
    args = _on(cuda_device, m2, conics, ch, opac, bins)
    got = {d: tras._blend_kernel(*args, w, h, _design=d) for d in tras.BLEND_FWD_DESIGNS}
    want = tras._blend_twin(*args, w, h)
    torch.cuda.synchronize()
    for a, b in zip(got["culled"], got["per_pixel"]):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(got["culled"][0]).all())
    peak = args[2].abs().amax(dim=0).clamp_min(1.0)
    assert float(((got["culled"][0] - want).abs().amax(dim=(0, 1)) / peak).max()) <= 2e-4
