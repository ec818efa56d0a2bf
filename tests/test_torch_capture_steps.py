"""One nerfacto training step of the factory-built pipelines on captures
that are not clean pinhole ones, the port's against JAX's with JAX's draws
handed in, at test_torch_trainer's tolerances (the loss and its terms to
2e-3; each non-table gradient within 5e-2 of its largest entry; each
table's gradient summed per level and feature within 1e-3 of the largest
such sum, the proposal table's within 1e-2):

* ``distorted``: the fixture capture as an OPENCV camera with k1 = -0.18
  and k2 = 0.04 (the synthetic tool's ``distorted`` scene's terms), so
  every ray goes through the 10-step Newton undistortion;
* ``masked_buckets``: a capture of two resolutions, each frame masked (its
  left quarter excluded), sampled per resolution bucket from the
  mask-valid tables.

Both start from the tiny model with flat hash tables (as
test_torch_train_step's main cases). The field's MLP biases (the density
MLP's and the colour head's) are held to JAX's gradient with the field's
MLPs in float32, as test_torch_trainer holds the head's: each bias
gradient sums every sample's cotangent, and JAX's bfloat16 products round
that sum further from its own float32 value than the port's do (asserted;
the port's per-ray forward equals JAX's to ~1e-7 on these captures, and
the density MLP's biases read 2-5% off JAX's bfloat16 gradient on the
plain fixture capture as on these)."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import NUM_IMAGES, TINY_MODEL, jax_occupancy_draws, jax_step_draws, to_torch
from fixtures import make_mixed_res_fixture, make_nerfstudio_fixture
from test_torch_train_step import _flat_tables
from test_torch_trainer import RAYS, _config, _jax_grads
from nerfstudio_tpu.data import pixel_samplers as jps
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.pipelines.base_pipeline import StepDraws
from nerfstudio_torch.utils.convert import params_from_jax, trainer_checkpoint_from_jax

STEP = 304  # the early point of the schedule: live proposals, the full field backward
HW = 16


def _capture(root: Path, kind: str) -> Path:
    if kind == "distorted":
        path = make_nerfstudio_fixture(root, n=NUM_IMAGES + 1, hw=HW)
        meta = json.loads((path / "transforms.json").read_text())
        meta.update(k1=-0.18, k2=0.04)
        (path / "transforms.json").write_text(json.dumps(meta))
        return path
    return make_mixed_res_fixture(root, n=NUM_IMAGES + 1, hws=(HW, 12), masks=True)


def _pipelines(scene):
    """JAX's and the port's factory-built nerfacto at the tiny model, frame
    0 held out, JAX's params (flat tables) restored into the port."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.pipelines.factory import build_pipeline

    jconfig = jget_method("nerfacto")
    jconfig.model = dataclasses.replace(jconfig.model, **TINY_MODEL)
    jconfig.data = scene
    jconfig.dataparser.eval_mode, jconfig.dataparser.eval_interval = "interval", NUM_IMAGES + 1
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    m = jconfig.model
    params = _flat_tables(jax.device_get(jstate.params),
                          (m.log2_hashmap_size, m.proposal_net_args_list[-1]["log2_hashmap_size"]))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    pipe, state, config = build_pipeline(_config("nerfacto", scene, Path("unused"), 1, **TINY_MODEL))
    ttrainer.restore_train_state(pipe, state, trainer_checkpoint_from_jax(jax.device_get(jstate), pipe.model,
                                                                          state.optimizer))
    return jpipe, jstate, jconfig, pipe, state, config


def _pixel_draws(jpipe, key, tdm):
    """JAX's pixel draws of one step from ``key`` as the port takes them:
    the uniform draw of a flat split, each bucket's (slot, row, col) of a
    bucketed one (reference ``_sample_train_batch_bucketed``)."""
    dm = jpipe.datamanager
    k_pix, _ = jax.random.split(key)
    if not isinstance(dm.train_images, tuple):
        return jax_step_draws(key, RAYS, NUM_IMAGES, HW, HW).pixels
    keys = jax.random.split(k_pix, len(dm.train_images))
    return tuple(to_torch(jps.sample_pixel_indices_from_valid(k, r, v))
                 for k, r, v in zip(keys, dm._bucket_ray_alloc(RAYS), dm.bucket_valid))


@pytest.mark.parametrize("kind", ["distorted", "masked_buckets"])
def test_step_matches_jax(tmp_path, kind):
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto

    jpipe, jstate, jconfig, pipe, state, config = _pipelines(_capture(tmp_path / kind, kind))
    tdm = pipe.datamanager
    if kind == "distorted":
        assert tdm.train_cameras.distorted and not isinstance(tdm.train_images, tuple)
    else:
        assert isinstance(tdm.train_images, tuple) and len(tdm.bucket_valid) == 2
    jstate = jstate.replace(step=jax.numpy.asarray(STEP, jax.numpy.int32))
    state.step = STEP
    k_aux, k_step = jax.random.split(jax.random.PRNGKey(7))
    jstate = jpipe.aux_update_fn(jstate, STEP, k_aux)
    cells, jitter = jax_occupancy_draws(k_aux, jconfig.model.occ_grid_resolution, jconfig.model.occ_cells_per_update)
    pipe.aux_update_fn(state, STEP, cells=cells, jitter=jitter)
    kwargs = JNerfacto.step_kwargs(STEP, jconfig.model)
    model = pipe.model
    jgrads = params_from_jax(_jax_grads(jpipe, jstate.params, jstate.aux, k_step, kwargs), model)
    jgrads32 = params_from_jax(_jax_grads(jpipe, jstate.params, jstate.aux, k_step, kwargs, head_float32=True), model)
    jstate, jmetrics = jpipe.train_step(jstate, jpipe.datamanager.train_images, k_step, **kwargs)
    draws = jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW)
    draws = StepDraws(_pixel_draws(jpipe, k_step, tdm), draws.sampler)
    tmetrics = pipe.train_step(state, draws=draws, **kwargs)
    for k in ("loss", "rgb_loss", "distortion_loss", "interlevel_loss", "psnr"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=2e-3, atol=1e-7, err_msg=k)
    off_float32 = {"port": 0.0, "jax": 0.0}
    for n, p in model.named_parameters():
        field_bias = n.startswith(("field.mlp_head", "field.mlp_base")) and n.endswith("bias")
        ref = (jgrads32 if field_bias else jgrads)[n].numpy().astype(np.float64)
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy().astype(np.float64)
        if field_bias:
            for side, g in (("port", got), ("jax", jgrads[n].numpy())):
                off_float32[side] = max(off_float32[side], np.abs(g - ref).max() / np.abs(ref).max())
        if n.endswith("hash_table"):
            log2_t = config.model.log2_hashmap_size if n.startswith("field") else \
                config.model.proposal_net_args_list[-1]["log2_hashmap_size"]
            F = 128 * got.shape[1] // 2**log2_t
            got, ref = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, ref))
            rel = 1e-2 if n.startswith("proposal_networks") else 1e-3
            np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=n)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * np.abs(ref).max() + 1e-10, err_msg=n)
    assert off_float32["port"] < off_float32["jax"], off_float32
    assert torch.isfinite(torch.stack([v for v in tmetrics.values()])).all()
