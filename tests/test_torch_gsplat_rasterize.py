"""K5 (tile binning) and K6 (saturating blend): the port's plain PyTorch
twins against the JAX package's ``_tile_keys_packed`` + sort +
``searchsorted`` and ``rasterize(mode="saturating")``, on the CPU, at
splatfacto's shipped binning (tiles_per_gauss 16, big_frac 16,
big_tiles_per_gauss 64) on gaussians projected by the JAX package.

Tolerances: K5's keys, ids, tile starts and counts exactly equal. K6's rgb
and accumulation within 2e-4 absolute: the port stops a pixel once its
transmittance is below 1e-4, the reference blends on to the end of its
64-entry chunk, so at most 1e-4 of weight differs per channel value <= 1
(plus float32 noise). Gradients within 1e-3 of each array's peak, the same
cutoff seen from the backward. The CUDA kernels are held against these
twins on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (a fixture)
from nerfstudio_tpu.ops.gsplat import projection as jproj
from nerfstudio_tpu.ops.gsplat import rasterize as jras
from nerfstudio_torch.ops.gsplat import rasterize as tras

BINNING = dict(tiles_per_gauss=16, big_frac=16, big_tiles_per_gauss=64)


def _scene(n, w, h, seed, log_scale=(-4.0, -1.5)):
    """JAX-projected gaussians (numpy): means2d, conics, depths, radii,
    valid, with one gaussian behind the camera and one off screen."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(*log_scale, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    pos = np.array([2.5, 0.3, 1.2])
    fwd = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    c2w = np.stack([right, np.cross(fwd, right), fwd, pos], -1).astype(np.float32)
    means[0] = pos + 2.0 * fwd  # behind the camera
    means[1] = pos - 2.0 * fwd + 6.0 * right  # in front, off screen
    vm = jproj.get_viewmat(jnp.asarray(c2w))
    out = jproj.project_gaussians(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), vm,
                                  np.float32(1.2 * w), np.float32(1.2 * w), np.float32(w / 2), np.float32(h / 2), w, h)
    m2, depths, conics, radii, valid, _ = (np.asarray(x) for x in out)
    assert not valid[0] and not valid[1]
    return m2, conics, depths, radii, valid


def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


@pytest.mark.parametrize("w,h,n,seed", [(256, 192, 1500, 0), (64, 48, 400, 1)])
def test_tile_binning_matches_jax_exactly(w, h, n, seed):
    m2, _, depths, radii, valid = _scene(n, w, h, seed, log_scale=(-4.0, -1.0))
    tiles_x, tiles_y = (w + 15) // 16, (h + 15) // 16
    keys, ids, depth_bits = jras._tile_keys_packed(jnp.asarray(m2), jnp.asarray(radii), jnp.asarray(depths),
                                                   jnp.asarray(valid), tiles_x, tiles_y, **BINNING)
    keys_s, ids_s = jax.lax.sort((keys, ids), num_keys=1)
    keys_s, ids_s = np.asarray(keys_s).astype(np.int64), np.asarray(ids_s)
    num_tiles = tiles_x * tiles_y
    starts = np.searchsorted(keys_s, np.arange(num_tiles + 1, dtype=np.int64) << depth_bits, side="left")
    live = starts[-1]
    # radii are integers: the big window's top-k lands on ties
    r_big = np.sort(np.where(valid, radii, -1.0))[::-1][: max(n // 16, 1)]
    assert len(np.unique(r_big)) < len(r_big) and (r_big > 32).sum() > 5

    bins = tras.tile_bin(*_t(m2, radii, depths, valid), w, h, **BINNING)
    assert bins.depth_bits == depth_bits
    np.testing.assert_array_equal(bins.keys.numpy(), keys_s)
    # Equal keys mean one tile and equal top depth bits (24 of them at 192
    # tiles, 28 at 12). The reference's sort orders such ties arbitrarily,
    # the port by gaussian id: the cost is the blending order of splats
    # whose depths agree to ~2^-(depth_bits - 8) relative. With distinct
    # keys the ids are equal outright.
    ties = live - len(np.unique(keys_s[:live]))
    assert ties == 0 if w == 64 else ties > 0
    by_id = ids_s[np.lexsort((ids_s, keys_s))]
    np.testing.assert_array_equal(bins.ids[:live].numpy(), by_id[:live])
    np.testing.assert_array_equal(bins.starts.numpy(), starts[:-1])
    np.testing.assert_array_equal(bins.counts.numpy(), np.diff(starts))
    # sentinel entries (tile = num_tiles) are never read; their ids match as a set
    np.testing.assert_array_equal(np.sort(bins.ids[live:].numpy()), np.sort(ids_s[live:]))
    # the unsorted emission matches the reference's slot for slot
    tk, tid, _ = tras._tile_keys_twin(*_t(m2, radii, depths, valid), tiles_x, tiles_y, **BINNING)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keys).astype(np.int64))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(ids))
    assert counts_ok(bins, valid)


def counts_ok(bins, valid):
    """Invalid gaussians emit no key inside a tile."""
    return not np.isin(bins.ids[: int(bins.counts.sum())].numpy(), np.nonzero(~valid)[0]).any()


def test_big_gaussians_ties_lower_index_first():
    radii = torch.tensor([3.0, 7.0, 7.0, 2.0, 7.0, 5.0, 5.0, 9.0])
    valid = torch.tensor([True, True, True, True, False, True, True, True])
    got = tras.big_gaussians(radii, valid, big_frac=2)
    _, want = jax.lax.top_k(jnp.where(jnp.asarray(valid.numpy()), jnp.asarray(radii.numpy()), -1.0), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [7, 1, 2, 5])


@pytest.fixture(scope="module")
def blend_scene():
    w, h, n = 64, 48, 1200
    m2, conics, depths, radii, valid = _scene(n, w, h, seed=3, log_scale=(-3.0, -1.5))
    rng = np.random.default_rng(4)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    return w, h, (m2, conics, colors, opac, depths, radii, valid)


def _jax_raster(w, h):
    def f(m2, con, col, op, dep, radii, valid):
        return jras.rasterize(m2, con, col, op, dep, radii, valid, width=w, height=h, mode="saturating",
                              tile_chunk=4, blend_chunk_size=64, **BINNING)
    return f


def test_blend_values_match_jax(blend_scene):
    w, h, scene = blend_scene
    rgb, alpha, depth = (np.asarray(x) for x in _jax_raster(w, h)(*(jnp.asarray(x) for x in scene)))
    trgb, talpha, tdepth = (x.numpy() for x in tras.rasterize(*_t(*scene), width=w, height=h, **BINNING))
    assert trgb.shape == (h, w, 3) and talpha.shape == (h, w, 1) and tdepth.shape == (h, w, 1)
    assert np.abs(trgb - rgb).max() <= 2e-4
    assert np.abs(talpha - alpha).max() <= 2e-4
    # deep tiles: the transmittance cutoff is reached
    assert (alpha > 1 - 1e-4).mean() > 0.2
    covered = alpha[..., 0] > 0.5
    np.testing.assert_allclose(tdepth[covered], depth[covered], rtol=1e-3)


@pytest.mark.parametrize("cotangent", ["training", "depth"])
def test_blend_vjp_matches_jax(blend_scene, cotangent):
    """``training``: the cotangents splatfacto's loss gives, into rgb and,
    through ``rgb + bg * (1 - alpha)``, into the accumulation; 1e-3 of each
    gradient's peak. ``depth``: a cotangent on the depth image alone where
    the accumulation exceeds 0.5. The depth channel carries the depths
    (up to ``max(depths)``, not 1), so the cutoff's residual weight, and the
    tolerance, scale by ``max(depths)``."""
    w, h, scene = blend_scene
    m2, conics, colors, opac, depths, radii, valid = scene
    rng = np.random.default_rng(5)
    jf = _jax_raster(w, h)
    zeros = [np.zeros((h, w, c), np.float32) for c in (3, 1, 1)]
    if cotangent == "training":
        g_rgb = rng.normal(size=(h, w, 3)).astype(np.float32)
        bg = rng.uniform(0, 1, 3).astype(np.float32)
        cots, tol = [g_rgb, -(g_rgb * bg).sum(-1, keepdims=True), zeros[2]], 1e-3
    else:
        acc = np.asarray(jf(*(jnp.asarray(x) for x in scene))[1])
        g_depth = rng.normal(size=(h, w, 1)).astype(np.float32) * (acc > 0.5)
        cots, tol = [zeros[0], zeros[1], g_depth], 1e-3 * float(depths[valid].max())
    _, pull = jax.vjp(lambda a, b, c, d, e: jf(a, b, c, d, e, jnp.asarray(radii), jnp.asarray(valid)),
                      *(jnp.asarray(x) for x in (m2, conics, colors, opac, depths)))
    jgrads = pull(tuple(jnp.asarray(g) for g in cots))
    leaves = [x.requires_grad_(True) for x in _t(m2, conics, colors, opac, depths)]
    out = tras.rasterize(*leaves, *_t(radii, valid), width=w, height=h, **BINNING)
    tgrads = torch.autograd.grad(out, leaves, _t(*cots), allow_unused=True)
    for name, a, b in zip(("means2d", "conics", "colors", "opacities", "depths"), jgrads, tgrads):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.isfinite(b).all(), name
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), (name, np.abs(a - b).max(), np.abs(a).max())
    # every array but one (colors or depths, which only one cotangent reaches) gets a gradient
    assert sum(np.abs(np.asarray(g)).max() > 0 for g in jgrads) == 4


@pytest.fixture(scope="module")
def dense_scene():
    """3000 gaussians over 64x48: tiles of more than two staged batches (256
    entries each) of the CUDA backward, pixels that saturate long before
    their tile's last entry. (means2d, conics, ch, opac, bins, w, h) as CPU
    tensors."""
    w, h, n = 64, 48, 3000
    m2, conics, depths, radii, valid = _scene(n, w, h, seed=6, log_scale=(-3.0, -1.5))
    rng = np.random.default_rng(7)
    ch = np.concatenate([rng.uniform(0, 1, (n, 3)), depths[:, None], np.ones((n, 1))], -1).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    bins = tras.tile_bin(*_t(m2, radii, depths, valid), w, h, **BINNING)
    return (*_t(m2, conics, ch, opac), bins, w, h)


def test_dense_scene_spans_several_staged_batches(dense_scene):
    """The premise of the card test below, checked on the twin: some tiles
    hold more than two 256-entry batches, and most pixels saturate (their
    replay starts inside a batch, not at a tile's end)."""
    m2, conics, ch, opac, bins, w, h = dense_scene
    assert int(bins.counts.max()) > 2 * 256 and int((bins.counts > 256).sum()) >= 4
    acc = tras._blend_twin(m2, conics, ch, opac, bins, w, h)[..., 4]
    assert float((acc > 1 - 1e-4).float().mean()) > 0.5


def test_blend_bwd_kernels_match_the_twin_on_the_card(cuda_device, dense_scene):
    """K6's backward against the twin's autograd on the card, within 1e-3
    of each array's peak (the T < 1e-4 cutoff seen from the replay, sums in
    another order), on tiles of several staged batches whose pixels stop
    mid-batch."""
    m2, conics, ch, opac, bins, w, h = dense_scene
    dev = lambda x: x.to(cuda_device)  # noqa: E731
    m2, conics, ch, opac = map(dev, (m2, conics, ch, opac))
    bins = tras.TileBins(*map(dev, (bins.packed, bins.ids, bins.starts, bins.counts)), bins.tiles_x, bins.tiles_y,
                         bins.depth_bits, bins.id_bits)
    _, T, last = tras._blend_kernel(m2, conics, ch, opac, bins, w, h)
    tile = (torch.arange(h, device=cuda_device)[:, None] // 16) * bins.tiles_x + \
        torch.arange(w, device=cuda_device)[None, :] // 16
    stopped = (T < 1e-4) & (last < bins.counts[tile])
    assert bool((stopped & (last % 256 != 0) & (last > 256)).any())
    g = torch.randn((h, w, 5), generator=torch.Generator(device=cuda_device).manual_seed(10), device=cuda_device)
    want = tras._blend_twin_bwd(m2, conics, ch, opac, bins, g)
    got = tras._blend_bwd_kernel(m2, conics, ch, opac, bins, T, last, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_bounded_mode_is_retired(blend_scene):
    w, h, scene = blend_scene
    with pytest.raises(NotImplementedError, match="bounded"):
        tras.rasterize(*_t(*scene), width=w, height=h, mode="bounded")
