"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seed and handed to both packages as
numpy arrays; parameters come from the JAX model's ``init`` and reach the
port through ``nerfstudio_torch.utils.convert.params_from_jax``."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

# The port's entry points run on the GPU unless asked otherwise; every port
# test runs on the CPU and says so with this device.
CPU = "cpu"

# torch's CPU sin runs MKL's threaded vmsSin, asked for high accuracy. On
# the first call in a process one of MKL's threads now and then computes its
# chunk in MKL's enhanced-performance mode instead (~11 bits, up to 1.5e-4
# off; bit-equal to vmsSin with VML_EP); the next call is within 4e-8. The
# NeRF-encoding parity test compares sines at 3e-5 and is the first test of
# its xdist worker, so every test process makes a first call here, on
# enough values to reach each of MKL's threads.
torch.sin(torch.linspace(-4.0, 4.0, 1 << 16))


@pytest.fixture
def cuda_device():
    """The first CUDA device, for the tests of kernels that run only on the
    card; decided when the test runs (never at import), skipped without one.
    chip_smoke.py runs the same checks on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc): the hand-written kernels run only on the card")
    return torch.device("cuda")


# hash_grid's launch counts after a run on the CPU: no kernel launched.
NO_HASH_LAUNCHES = {"hash_encode_block": 0, "hash_encode_block_exact": 0, "hash_encode_block_bwd": 0,
                    "hash_encode_flat": 0, "hash_encode_flat_bwd": 0, "hash_encode_block_exact_bwd": 0,
                    "hash_encode_block_bwd_bwd": 0, "hash_encode_block_per_thread": 0,
                    "hash_encode_bwd_per_thread": 0, "hash_encode_flat_per_thread": 0}

# Tiny nerfacto: 4 field levels at T=2^12 (levels 0-1 dense, 2-3 hashed),
# a 4-level proposal net, 16-wide MLPs, 16 probes / 8 proposal / 8 field
# samples, a 16^3 occupancy grid.
TINY_MODEL = dict(
    num_levels=4,
    base_res=4,
    max_res=64,
    log2_hashmap_size=12,
    features_per_level=4,
    hidden_dim=16,
    hidden_dim_color=16,
    appearance_embed_dim=8,
    num_proposal_samples_per_ray=(16, 8),
    num_nerf_samples_per_ray=8,
    occ_num_probes=16,
    occ_grid_resolution=16,
    average_init_density=1.0,
    proposal_net_args_list=(
        {"hidden_dim": 16, "log2_hashmap_size": 12, "num_levels": 4, "base_res": 4, "max_res": 32},
        {"hidden_dim": 16, "log2_hashmap_size": 12, "num_levels": 4, "base_res": 4, "max_res": 64},
    ),
)
NUM_IMAGES = 4
HW = 16


def orbit_c2w(n_images: int) -> np.ndarray:
    """Orbit cameras at radius 2, height 1, looking at the origin
    (the layout of ``__graft_entry__._synthetic_setup``)."""
    thetas = 2 * np.pi * np.arange(n_images) / n_images
    c2w = np.zeros((n_images, 3, 4), np.float32)
    for i, t in enumerate(thetas):
        pos = np.array([2 * np.cos(t), 2 * np.sin(t), 1.0])
        fwd = pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 0, 1]), fwd)
        right /= np.linalg.norm(right)
        c2w[i, :, 0] = right
        c2w[i, :, 1] = np.cross(fwd, right)
        c2w[i, :, 2] = fwd
        c2w[i, :, 3] = pos
    return c2w


# The nerfacto method config's training schedule (configs/method_configs.py
# :92-110), which the model-config defaults leave off.
METHOD_SCHEDULE = dict(field_bwd_level_period=2, proposal_freeze_after=2500)


def jax_tiny_nerfacto(train: bool = False):
    """(JAX model, its config) at TINY_MODEL with the nerfacto method
    config's other settings."""
    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.models.nerfacto import NerfactoModel

    cfg = dataclasses.replace(get_method("nerfacto").model, **TINY_MODEL)
    model = NerfactoModel(
        config=cfg, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)), num_train_data=NUM_IMAGES, train=train
    )
    return model, cfg


def torch_tiny_nerfacto(train: bool = False):
    """The port's model at TINY_MODEL and the method config's schedule, in
    eval mode (or training mode with ``train``)."""
    from nerfstudio_torch.models.nerfacto import NerfactoModelConfig

    cfg = NerfactoModelConfig(eval_num_rays_per_chunk=1 << 15, **TINY_MODEL, **METHOD_SCHEDULE)
    return cfg.setup(num_train_data=NUM_IMAGES, device=CPU).train(train)


def jax_step_draws(key, num_rays: int, num_images: int, height: int, width: int, n_rounds: int = 2):
    """The port's ``StepDraws`` holding what the JAX train step draws from
    ``key`` (base_pipeline.py train_step): pixel indices from its first
    half (pixel_samplers.sample_pixel_indices), then, from the model's key,
    the sampler's keys (ray_samplers.py:280-290): round i jitters from key
    i, the occupancy probes from the last; (num_rays, 1) each with
    single_jitter."""
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws

    k_pix, k_model = jax.random.split(key)
    kc, kr, kw = jax.random.split(k_pix, 3)
    pixels = np.stack(
        [
            np.asarray(jax.random.randint(kc, (num_rays,), 0, num_images)),
            np.asarray(jax.random.randint(kr, (num_rays,), 0, height)),
            np.asarray(jax.random.randint(kw, (num_rays,), 0, width)),
        ],
        axis=-1,
    ).astype(np.int64)
    k_samp, _ = jax.random.split(k_model)
    keys = jax.random.split(k_samp, n_rounds + 1)
    jitter = [to_torch(jax.random.uniform(k, (num_rays, 1))) for k in keys]
    return StepDraws(to_torch(pixels), SamplerUniforms(jitter[n_rounds], tuple(jitter[:n_rounds])))


def jax_occupancy_draws(key, resolution: int, cells_per_update: int):
    """(cells, jitter) as torch tensors, as ``ops/occupancy.py``'s
    ``update_occupancy_grid`` draws them from ``key`` (every cell in order
    when the update covers the grid)."""
    n = resolution**3
    k_idx, k_jit = jax.random.split(key)
    if cells_per_update < n:
        cells = np.asarray(jax.random.randint(k_idx, (cells_per_update,), 0, n, jax.numpy.int32))
    else:
        cells = np.arange(n)
    return to_torch(cells.astype(np.int64)), to_torch(jax.random.uniform(k_jit, (cells.shape[0], 3)))


def init_params(init_fn, seed: int):
    """The JAX model's own ``init`` (jitted: one compile instead of an
    op-by-op run) at ``PRNGKey(seed)``, as numpy, with every hash table
    redrawn uniform in +-1 from a numpy seed: the init's +-1e-3 leaves the
    encodings without structure at this size."""
    params = jax.device_get(jax.jit(init_fn)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def widen(path, x):
        if jax.tree_util.keystr(path).endswith("['hash_table']"):
            return rng.uniform(-1.0, 1.0, np.shape(x)).astype(np.float32)
        return np.array(x)

    return jax.tree_util.tree_map_with_path(widen, params)


def ray_positions(rng: np.random.Generator, rays: int = 4, samples: int = 1000, clip: bool = True) -> np.ndarray:
    """(rays * samples, 3) float32 positions on straight rays through the
    unit cube, in ray order as a sampler lays them out, spaced ~1/1000 of
    the cube: the coarse levels' entries each take hundreds of terms.
    Without ``clip`` the rays run out of the cube at both ends."""
    o = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = o + np.linspace(-0.6, 0.6, samples)[None, :, None] * d
    return (np.clip(p, 0.0, 1.0) if clip else p).reshape(-1, 3).astype(np.float32)


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def sphere_grid_binary(res: int, radius: float = 0.3) -> np.ndarray:
    """(res^3,) occupancy: cells whose centre lies within ``radius`` of the
    normalised cube's centre."""
    c = (np.arange(res) + 0.5) / res - 0.5
    d2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    return (d2 <= radius**2).reshape(-1)


def make_synthetic_scene(root) -> "Path":
    """``tools/make_synthetic_dataset.py ROOT --hw 32 --n-train 8 --n-test 2
    --n-points 500`` (the ``basic`` scene, small): transforms.json over the
    10 train and test frames, the Blender splits and points3D.ply."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, str(repo / "tools" / "make_synthetic_dataset.py"), str(root), "--hw", "32",
                    "--n-train", "8", "--n-test", "2", "--n-points", "500"], check=True, capture_output=True,
                   timeout=300)
    return Path(root)
