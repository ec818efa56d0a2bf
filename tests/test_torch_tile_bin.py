"""K5 (tile binning): the host plan of the card's tile-bucketed design, and
the twin's live bins against the JAX package's ``_tile_keys_packed``.

The bucketed design (``rasterize.bin_plan``, ``csrc/gsplat.cu``
``tile_count_kernel`` ff.) writes only the live (tile, gaussian) pairs:
``starts``, ``counts`` and the first ``counts.sum()`` entries of ``packed``
and ``ids`` must equal the twin's exactly, the rest of those arrays is
undefined on the card. So the twin's live part is pinned here against the
reference, on the CPU: its count is the number of the reference's keys
whose tile lies below ``num_tiles``, and its packed keys are the
reference's live keys with the id packed under them, sorted. The kernels
themselves run only on the card (``chip_smoke.py`` phase 14 and the card
test below)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (a fixture)
from nerfstudio_tpu.ops.gsplat import rasterize as jras
from nerfstudio_torch.ops.gsplat import _cuda as sc
from nerfstudio_torch.ops.gsplat import rasterize as tras

BINNING = dict(tiles_per_gauss=16, big_frac=16, big_tiles_per_gauss=64)


def _gaussians(n, w, h, seed, crowd=0):
    """Screen-space gaussians (numpy): means over the image and a margin
    around it, integer radii up to 80 px (so the big window's top-k holds
    ties and splats wider than the base window), depths, 90% valid. The
    first ``crowd`` gaussians sit inside one tile with radius 2."""
    rng = np.random.default_rng(seed)
    m2 = (rng.uniform(-0.1, 1.1, (n, 2)) * [w, h]).astype(np.float32)
    radii = np.ceil(rng.uniform(0.0, 1.0, n) ** 4 * 80).astype(np.float32)
    depths = rng.uniform(0.1, 10.0, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    m2[:crowd] = rng.uniform(17.0, 31.0, (crowd, 2))
    radii[:crowd] = 2.0
    valid[:crowd] = True
    return m2, radii, depths, valid


@pytest.mark.parametrize("w,h,n,seed,crowd", [(256, 192, 1500, 0, 0), (64, 48, 400, 1, 0), (128, 96, 900, 2, 300)])
def test_twin_live_bins_match_jax_keys(w, h, n, seed, crowd):
    m2, radii, depths, valid = _gaussians(n, w, h, seed, crowd)
    tiles_x, tiles_y = (w + 15) // 16, (h + 15) // 16
    num_tiles = tiles_x * tiles_y
    keys, ids, depth_bits = jras._tile_keys_packed(jnp.asarray(m2), jnp.asarray(radii), jnp.asarray(depths),
                                                   jnp.asarray(valid), tiles_x, tiles_y, **BINNING)
    keys, ids = np.asarray(keys).astype(np.int64), np.asarray(ids).astype(np.int64)
    live = (keys >> depth_bits) < num_tiles
    assert 0 < live.sum() < live.size  # the reference emits sentinels for the dead slots

    bins = tras.tile_bin(*(torch.from_numpy(x) for x in (m2, radii, depths, valid)), w, h, **BINNING)
    total = int(bins.counts.sum())
    assert total == int(live.sum())
    want = np.sort((keys[live] << bins.id_bits) | ids[live])
    np.testing.assert_array_equal(bins.packed[:total].numpy(), want)
    np.testing.assert_array_equal(bins.ids[:total].numpy(), want & ((1 << bins.id_bits) - 1))
    per_tile = np.bincount(keys[live] >> depth_bits, minlength=num_tiles)
    np.testing.assert_array_equal(bins.counts.numpy(), per_tile)
    np.testing.assert_array_equal(bins.starts.numpy(), np.cumsum(per_tile) - per_tile)
    if crowd:  # the crowded tile holds every crowd member once
        assert int(bins.counts[tiles_x + 1]) >= crowd


def test_plan_at_splatfacto_shipped_binning():
    """100,000 slots, the top 6,250 in the big window, 512^2 (1,024 tiles):
    2.0M window slots, a 4 KB histogram (of the 227 KB a block may take),
    2,048 keys sorted at once per block (more than the longest tile of
    chip_smoke.py's check and trained inputs, 1,353), and the scratch: the
    tiles' cursors and the unsorted keys."""
    plan = tras.bin_plan(100_000, 6_250, 4, 8, 1024)
    assert plan == tras.BinPlan(pairs=2_000_000, sort_keys=2048, hist_bytes=4096, scratch_bytes=4096 + 16_000_000)
    assert plan.hist_bytes <= tras.SHARED_BYTES_PER_BLOCK == 227 * 1024


def test_plan_takes_a_4k_frame_and_refuses_beyond_its_limits():
    """The histogram holds 58,112 tiles (a 3840x2160 frame has 32,400); one
    more, or 2^31 window slots, raises with the limit in the message."""
    assert tras.bin_plan(1000, 62, 4, 8, 240 * 135).hist_bytes == 4 * 32_400
    limit = tras.SHARED_BYTES_PER_BLOCK // 4
    assert limit == 58_112 and tras.bin_plan(10, 1, 4, 8, limit).hist_bytes == tras.SHARED_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="58112 tiles"):
        tras.bin_plan(10, 1, 4, 8, limit + 1)
    with pytest.raises(ValueError, match="2\\^31"):
        tras.bin_plan(2**27, 0, 4, 8, 1024)  # 16 * 2^27 = 2^31 slots
    assert tras.bin_plan(2**27 - 1, 0, 4, 8, 1024).pairs == 2**31 - 16


def test_designs_and_the_cpu_path():
    """The card's designs, the default first; an unknown design raises
    before anything touches a device; CPU tensors run the twin and launch
    nothing."""
    assert tras.TILE_BIN_DESIGNS == ("bucketed", "sorted")
    m2, radii, depths, valid = (torch.from_numpy(x) for x in _gaussians(200, 64, 48, 3))
    with pytest.raises(ValueError, match="design"):
        tras._tile_bin_kernel(m2, radii, depths, valid, 4, 3, 16, 16, 64, _design="radix")
    sc.reset_launch_counts()
    tras.tile_bin(m2, radii, depths, valid, 64, 48, **BINNING)
    assert all(v == 0 for v in sc.launch_counts.values()) and "tile_bin_bucketed" in sc.launch_counts


def test_tile_bin_designs_match_the_twin_on_the_card(cuda_device):
    """Both designs against the twin on the card: starts, counts and the
    live entries of packed and ids exactly equal, at a tile longer than the
    keys one block of the bucketed sort orders at once (its merge path)
    and without one."""
    for crowd in (0, tras.TILE_SORT_KEYS + 3000):
        m2, radii, depths, valid = (torch.from_numpy(x).to(cuda_device)
                                    for x in _gaussians(crowd + 4000, 256, 192, 4, crowd))
        args = (m2, radii, depths, valid, 16, 12, 16, 16, 64)
        want = tras._tile_bin_twin(*args)
        total = int(want.counts.sum())
        assert (int(want.counts.max()) > tras.TILE_SORT_KEYS) == bool(crowd)
        for design in tras.TILE_BIN_DESIGNS:
            got = tras._tile_bin_kernel(*args, _design=design)
            torch.cuda.synchronize()
            for k in ("starts", "counts"):
                assert torch.equal(getattr(got, k), getattr(want, k)), (design, k)
            for k in ("packed", "ids"):
                assert torch.equal(getattr(got, k)[:total], getattr(want, k)[:total]), (design, k)


@pytest.mark.parametrize("over", [0, 1], ids=["at_the_limit", "one_tile_over"])
def test_routing_by_tile_count(monkeypatch, over):
    """A frame of more tiles than the bucketed design's histogram holds
    takes the sorted design (its two C entries, counted under
    ``tile_bin_sorted``); a frame at the limit the bucketed one. Shared
    memory is cut to a 12-tile histogram; the C entries are recorded, not
    run (CPU tensors)."""
    monkeypatch.setattr(tras, "SHARED_BYTES_PER_BLOCK", 4 * 12)
    calls = []
    monkeypatch.setattr(sc, "launch", lambda name, fn, dev, *args: calls.append((name, fn)))
    m2, radii, depths, valid = (torch.from_numpy(x) for x in _gaussians(50, 64, 48, 5))
    tiles_x, tiles_y = (4, 3) if not over else (13, 1)
    assert tras.tile_bin_design(tiles_x * tiles_y) == ("sorted" if over else "bucketed")
    sc.reset_launch_counts()
    bins = tras._tile_bin_kernel(m2, radii, depths, valid, tiles_x, tiles_y, 16, 16, 64)
    if over:
        assert calls == [(None, "nst_gsplat_tile_keys"), ("tile_bin_sorted", "nst_gsplat_tile_ranges")]
    else:
        assert calls == [("tile_bin_bucketed", "nst_gsplat_tile_bin")]
    assert sc.launch_counts["tile_bin"] == 1 and bins.starts.shape == (tiles_x * tiles_y,)
    monkeypatch.undo()
    assert tras.tile_bin_design(58_112) == "bucketed" and tras.tile_bin_design(58_113) == "sorted"


def test_frame_above_the_tile_limit_matches_the_twin_on_the_card(cuda_device):
    """A 4096x4352 frame (69,632 tiles, above the bucketed design's 58,112)
    through the default routing: the sorted design, exact against the twin
    on starts, counts and the live entries."""
    m2, radii, depths, valid = (torch.from_numpy(x).to(cuda_device) for x in _gaussians(20_000, 4096, 4352, 6))
    args = (m2, radii, depths, valid, 256, 272, 16, 16, 64)
    sc.reset_launch_counts()
    got = tras._tile_bin_kernel(*args)
    want = tras._tile_bin_twin(*args)
    torch.cuda.synchronize()
    assert sc.launch_counts["tile_bin_sorted"] == 1 and sc.launch_counts["tile_bin_bucketed"] == 0
    total = int(want.counts.sum())
    for k in ("starts", "counts"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in ("packed", "ids"):
        assert torch.equal(getattr(got, k)[:total], getattr(want, k)[:total]), k
