"""The port's pixel samplers and device-resident datamanager against the
JAX package's: each sampler with JAX's draws handed in (indices exactly
equal), the mask-valid table, the per-bucket ray allocation (masked and
not), a whole batch of the flat, masked and bucketed (masked too) paths
with JAX's draws (indices and pixels exactly equal), masked draws from the
port's own generator landing only on valid pixels, and the resident
subsets with a reload (the slot -> camera maps and images equal)."""

import jax
import numpy as np
import pytest
import torch

from _torch_port import CPU, to_torch
from fixtures import make_mixed_res_fixture, make_nerfstudio_fixture
from nerfstudio_tpu.data import pixel_samplers as jps
from nerfstudio_tpu.data.datamanagers import DataManagerConfig as JDMConfig
from nerfstudio_tpu.data.datamanagers import DeviceCacheDataManager as JDeviceCache
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_tpu.data.datasets import InputDataset as JInputDataset
from nerfstudio_torch.data import pixel_samplers as tps
from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.data.datasets import InputDataset

N, H, W = 5, 24, 32
RAYS = 256


def _np(x):
    return np.asarray(x)


def _jax_draws(kind, key, rays, n=N, h=H, w=W, patch=4, radius=2, valid=None):
    """What each JAX sampler draws from ``key``, in its order."""
    if kind == "from_valid":
        return (jax.random.randint(key, (rays,), 0, valid.shape[0]),)
    if kind == "pair":
        kc, kr, kw, kd = jax.random.split(key, 4)
        m = rays // 2
        return (jax.random.randint(kc, (m,), 0, n), jax.random.randint(kr, (m,), radius, h - radius),
                jax.random.randint(kw, (m,), radius, w - radius), jax.random.randint(kd, (m, 2), -radius, radius + 1))
    kc, kr, kw = jax.random.split(key, 3)
    if kind == "patch":
        m = rays // patch**2
        return (jax.random.randint(kc, (m,), 0, n), jax.random.randint(kr, (m,), 0, h - patch + 1),
                jax.random.randint(kw, (m,), 0, w - patch + 1))
    c = jax.random.randint(kc, (rays,), 0, n)
    if kind == "uniform":
        return c, jax.random.randint(kr, (rays,), 0, h), jax.random.randint(kw, (rays,), 0, w)
    if kind == "fisheye":
        return c, jax.random.uniform(kr, (rays,)), jax.random.uniform(kw, (rays,))
    if kind == "equirectangular":
        return c, jax.random.uniform(kr, (rays,)), jax.random.randint(kw, (rays,), 0, w)
    raise ValueError(kind)


def _masks(seed=0, n=N, h=H, w=W):
    return np.random.default_rng(seed).uniform(size=(n, h, w, 1)) > 0.6


@pytest.mark.parametrize("kind", ["uniform", "fisheye", "equirectangular", "patch", "pair", "from_valid"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_with_jax_draws_equals_jax(kind, seed):
    key = jax.random.PRNGKey(seed)
    valid = jps.build_valid_indices(_masks(seed))
    ref = {
        "uniform": lambda: jps.sample_pixel_indices(key, RAYS, N, H, W),
        "fisheye": lambda: jps.sample_pixel_indices_fisheye(key, RAYS, N, H, W),
        "equirectangular": lambda: jps.sample_pixel_indices_equirectangular(key, RAYS, N, H, W),
        "patch": lambda: jps.sample_patch_pixel_indices(key, RAYS, 4, N, H, W),
        "pair": lambda: jps.sample_pair_pixel_indices(key, RAYS, N, H, W),
        "from_valid": lambda: jps.sample_pixel_indices_from_valid(key, RAYS, jax.numpy.asarray(valid)),
    }[kind]()
    draws = tuple(to_torch(d) for d in _jax_draws(kind, key, RAYS, valid=valid))
    out = {
        "uniform": lambda: tps.sample_pixel_indices(RAYS, N, H, W, draws=draws),
        "fisheye": lambda: tps.sample_pixel_indices_fisheye(RAYS, N, H, W, draws=draws),
        "equirectangular": lambda: tps.sample_pixel_indices_equirectangular(RAYS, N, H, W, draws=draws),
        "patch": lambda: tps.sample_patch_pixel_indices(RAYS, 4, N, H, W, draws=draws),
        "pair": lambda: tps.sample_pair_pixel_indices(RAYS, N, H, W, draws=draws),
        "from_valid": lambda: tps.sample_pixel_indices_from_valid(RAYS, torch.from_numpy(valid), draws=draws),
    }[kind]()
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), _np(ref))


@pytest.mark.parametrize("kind", ["uniform", "fisheye", "equirectangular", "patch", "pair"])
def test_sampler_draws_from_its_generator_in_range(kind):
    """Without draws each sampler takes its own from the generator: the
    same seed gives the same indices, every index lies in the image."""
    def run(seed):
        g = torch.Generator().manual_seed(seed)
        kw = dict(generator=g, device=CPU)
        return {"uniform": lambda: tps.sample_pixel_indices(RAYS, N, H, W, **kw),
                "fisheye": lambda: tps.sample_pixel_indices_fisheye(RAYS, N, H, W, **kw),
                "equirectangular": lambda: tps.sample_pixel_indices_equirectangular(RAYS, N, H, W, **kw),
                "patch": lambda: tps.sample_patch_pixel_indices(RAYS, 4, N, H, W, **kw),
                "pair": lambda: tps.sample_pair_pixel_indices(RAYS, N, H, W, **kw)}[kind]()

    a, b = run(3), run(3)
    assert torch.equal(a, b) and a.shape == (RAYS, 3)
    for col, hi in enumerate((N, H, W)):
        assert int(a[:, col].min()) >= 0 and int(a[:, col].max()) < hi


def test_build_valid_indices_equals_jax():
    masks = _masks(5)
    out = tps.build_valid_indices(masks)
    np.testing.assert_array_equal(out, jps.build_valid_indices(masks))
    assert out.dtype == np.int32 and masks[out[:, 0], out[:, 1], out[:, 2], 0].all()


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    return {"flat": make_nerfstudio_fixture(root / "flat", n=6, hw=16),
            "mixed": make_mixed_res_fixture(root / "mixed", n=7, hws=(16, 12, 20)),
            "mixed_masked": make_mixed_res_fixture(root / "mixed_masked", n=7, hws=(16, 12, 20), masks=True),
            "flat_masked": make_mixed_res_fixture(root / "flat_masked", n=5, hws=(16,), masks=True)}


def _managers(path, **cfg):
    """(JAX's DeviceCacheDataManager, the port's) of a capture's train
    split (eval mode "all": every frame)."""
    jout = JNerfstudio(data=path, eval_mode="all", downscale_factor=1).setup().get_dataparser_outputs("train")
    tout = NerfstudioDataParserConfig(data=path, eval_mode="all", downscale_factor=1).setup() \
        .get_dataparser_outputs("train")
    jdm = JDeviceCache(JDMConfig(**cfg), JInputDataset(jout))
    tdm = DeviceCacheDataManager.from_datasets(DataManagerConfig(**cfg), InputDataset(tout), device=CPU)
    return jdm, tdm


@pytest.mark.parametrize("capture", ["mixed", "mixed_masked"])
def test_bucket_ray_alloc_equals_jax(captures, capture):
    jdm, tdm = _managers(captures[capture])
    assert len(tdm.train_images) == len(jdm.train_images) == 3
    assert (tdm.bucket_valid is None) == (capture == "mixed")
    for rays in (3, 4, 7, 100, 4096):
        assert tdm._bucket_ray_alloc(rays) == jdm._bucket_ray_alloc(rays), rays
    with pytest.raises(ValueError, match="resolution buckets"):
        tdm._bucket_ray_alloc(2)
    jdm, tdm = _managers(captures["mixed"], max_images_in_memory=4)
    assert tdm._bucket_resident_counts == jdm._bucket_resident_counts
    for rays in (3, 100):
        assert tdm._bucket_ray_alloc(rays) == jdm._bucket_ray_alloc(rays)


def _jax_bucket_draws(jdm, key, rays):
    """JAX's per-bucket (slot, row, col) draws of one batch (reference
    ``_sample_train_batch_bucketed``)."""
    alloc = jdm._bucket_ray_alloc(rays)
    keys = jax.random.split(key, len(jdm.train_images))
    valids = jdm.bucket_valid or (None,) * len(keys)
    out = []
    for img, valid, k, r in zip(jdm.train_images, valids, keys, alloc):
        if valid is not None:
            out.append(jps.sample_pixel_indices_from_valid(k, r, valid))
        else:
            out.append(jps.sample_pixel_indices(k, r, img.shape[0], img.shape[1], img.shape[2]))
    return tuple(to_torch(x) for x in out)


@pytest.mark.parametrize("capture", ["flat", "flat_masked", "mixed", "mixed_masked"])
def test_batch_with_jax_draws_equals_jax(captures, capture):
    """A whole batch with JAX's draws handed in: the indices (original
    cameras) and the pixels, exactly."""
    jdm, tdm = _managers(captures[capture])
    key = jax.random.PRNGKey(11)
    jidx, jbatch = jdm.sample_train_batch(key, jdm.train_images, num_rays=64)
    if capture.startswith("mixed"):
        draws = _jax_bucket_draws(jdm, key, 64)
    elif jdm.valid_indices is not None:
        draws = to_torch(jps.sample_pixel_indices_from_valid(key, 64, jdm.valid_indices))
    else:
        draws = to_torch(jps.sample_pixel_indices(key, 64, len(tdm.train_images), tdm.image_height, tdm.image_width))
    idx, batch = tdm.sample_train_batch(num_rays=64, indices=draws)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_array_equal(batch["image"].numpy(), _np(jbatch["image"]))


@pytest.mark.parametrize("capture", ["flat_masked", "mixed_masked"])
def test_masked_draws_land_on_valid_pixels(captures, capture):
    """The port's own draws (its generator) hit only mask-valid pixels: the
    fixture masks out each image's left quarter."""
    _, tdm = _managers(captures[capture])
    idx, _ = tdm.sample_train_batch(torch.Generator().manual_seed(0), num_rays=2048)
    widths = tdm.train_cameras.width[idx[:, 0], 0]
    assert bool((idx[:, 2] >= widths // 4).all())
    assert int(idx[:, 2].min()) == int((widths // 4).min())


@pytest.mark.parametrize("capture", ["flat", "mixed"])
def test_resident_subset_and_reload_equal_jax(captures, capture):
    """``max_images_in_memory`` keeps the same images resident as JAX's
    manager, before and after a reload at ``steps_per_reload``; a batch
    with JAX's draws maps its slots to the same original cameras."""
    cfg = dict(max_images_in_memory=3, steps_per_reload=10)
    jdm, tdm = _managers(captures[capture], **cfg)

    def same():
        if capture == "flat":
            np.testing.assert_array_equal(tdm.resident_map.numpy(), _np(jdm.resident_map))
            np.testing.assert_array_equal(tdm.train_images.numpy(), _np(jdm.train_images))
        else:
            for t, j in zip(tdm.resident_map, jdm.resident_map):
                np.testing.assert_array_equal(t.numpy(), _np(j))
            for t, j in zip(tdm.train_images, jdm.train_images):
                np.testing.assert_array_equal(t.numpy(), _np(j))

    same()
    before = [m.clone() for m in tdm.resident_map] if capture == "mixed" else tdm.resident_map.clone()
    for step in (3, 10):
        tdm.maybe_reload(step)
        jdm.maybe_reload(step)
    same()
    if capture == "flat":
        assert not torch.equal(before, tdm.resident_map)
        key = jax.random.PRNGKey(2)
        jidx, jbatch = jdm.sample_train_batch(key, jdm.train_images, num_rays=32, resident_map=jdm.resident_map)
        draws = to_torch(jps.sample_pixel_indices(key, 32, 3, tdm.image_height, tdm.image_width))
        idx, batch = tdm.sample_train_batch(num_rays=32, indices=draws)
        np.testing.assert_array_equal(idx.numpy(), _np(jidx))
        np.testing.assert_array_equal(batch["image"].numpy(), _np(jbatch["image"]))


@pytest.mark.parametrize("sampler", ["uniform", "fisheye", "equirectangular", "patch", "pair"])
def test_manager_dispatches_the_configured_sampler(sampler):
    """A manager's own draw is its configured sampler's from the same
    generator (reference ``sample_train_batch`` :346-368); a mask, where
    there is one, takes precedence over the sampler."""
    from nerfstudio_torch.cameras.cameras import Cameras

    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3)).astype(np.uint8))
    cams = Cameras.create(np.tile(np.eye(4, dtype=np.float32)[:3], (N, 1, 1)), 20.0, 20.0, W / 2, H / 2, W, H,
                          device=CPU)
    cfg = DataManagerConfig(pixel_sampler=sampler, patch_size=4 if sampler == "patch" else 1)
    kw = dict(generator=torch.Generator().manual_seed(9), device=CPU)
    want = {"uniform": lambda: tps.sample_pixel_indices(RAYS, N, H, W, **kw),
            "fisheye": lambda: tps.sample_pixel_indices_fisheye(RAYS, N, H, W, **kw),
            "equirectangular": lambda: tps.sample_pixel_indices_equirectangular(RAYS, N, H, W, **kw),
            "patch": lambda: tps.sample_patch_pixel_indices(RAYS, 4, N, H, W, **kw),
            "pair": lambda: tps.sample_pair_pixel_indices(RAYS, N, H, W, **kw)}[sampler]()
    idx, batch = DeviceCacheDataManager(cfg, cams, images, CPU).sample_train_batch(
        torch.Generator().manual_seed(9), num_rays=RAYS)
    assert torch.equal(idx, want)
    assert torch.equal(batch["image"], images[idx[:, 0], idx[:, 1], idx[:, 2]].float() / 255.0)
    masks = _masks(4)
    idx, _ = DeviceCacheDataManager(cfg, cams, images, CPU, masks=masks).sample_train_batch(
        torch.Generator().manual_seed(9), num_rays=RAYS)
    assert masks[idx[:, 0], idx[:, 1], idx[:, 2], 0].all()
