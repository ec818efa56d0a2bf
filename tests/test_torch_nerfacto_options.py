"""nerfacto's sampling options in the port against the JAX reference on the
CPU: one factory-built training step each, at TINY_MODEL with the nerfacto
method config's schedule, on a 5-view capture at 16^2 through the
nerfstudio parser, with JAX's draws handed in:

* ``use_occupancy_sampler=False``: both proposal nets of
  ``proposal_net_args_list`` (upstream nerfacto's stack), no grid;
* ``num_proposal_iterations=0``: the occupancy grid's PDF alone;
* ``proposal_initial_sampler="uniform"``: uniform probes;
* ``occ_weight_mode="density"``: the probes weighted by the grid's EMA
  densities (floored at 1e-3);
* ``disable_scene_contraction=True``: the scene box in place of the
  contraction, for the field, the proposal net and the grid's probes.

The grid is handed to both sides (a sphere of occupied cells, EMA densities
falling off from its middle). Every hash table is flat (one value per level
and feature, so K1's rounding choices do not move the step) and every MLP
computes in float32 on both sides. Tolerances as test_torch_depth_nerfacto's
step: the loss and its terms within 2e-3 relative, each non-table gradient
within 5e-2 of its peak, each table's gradient summed per level and feature
within 1e-3 of the largest sum (a proposal table's 1e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import NUM_IMAGES, TINY_MODEL, jax_step_draws, sphere_grid_binary
from fixtures import make_nerfstudio_fixture
from test_torch_instant_ngp import jax_float32_mlps
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.utils.convert import occupancy_from_jax, params_from_jax

HW = 16
RAYS = 64
STEP = 304  # live proposals, the whole field backward
OPTIONS = {
    "two_proposal_nets": dict(use_occupancy_sampler=False),
    "occupancy_pdf_alone": dict(num_proposal_iterations=0),
    "uniform_probes": dict(proposal_initial_sampler="uniform"),
    "density_weights": dict(occ_weight_mode="density"),
    "scene_box": dict(disable_scene_contraction=True),
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_nerfstudio_fixture(tmp_path_factory.mktemp("options") / "scene", n=NUM_IMAGES + 1, hw=HW)


def _flat(params, seed=22):
    """Every hash table of the tree set to one value per level and feature."""
    rng = np.random.default_rng(seed)

    def flat(path, x):
        if not jax.tree_util.keystr(path).endswith("['hash_table']"):
            return np.array(x)
        L, S, _ = x.shape
        F = 128 * S // 2 ** TINY_MODEL["log2_hashmap_size"]
        values = rng.uniform(-1, 1, (L, F)).astype(np.float32)
        return np.ascontiguousarray(np.broadcast_to(np.tile(values, 128 // F)[:, None, :], (L, S, 128)))

    return jax.tree_util.tree_map_with_path(flat, params)


def _grid(res):
    """A JAX grid over the unit cube: the cells within 0.3 of the middle
    occupied, EMA densities 40 * exp(-25 r^2) (the packed views consistent)."""
    c = (np.arange(res) + 0.5) / res - 0.5
    r2 = (c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2).reshape(-1)
    dens = (40.0 * np.exp(-25.0 * r2)).astype(np.float32)
    binary = sphere_grid_binary(res)
    grid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res)
    return jax.device_get(grid.replace(
        densities=jnp.asarray(dens), binary=jnp.asarray(binary), binary_rows=jocc._pack_rows(jnp.asarray(binary), res),
        density_rows=jocc._pack_rows(jnp.asarray(dens), res)))


def _pair(scene, option):
    """JAX's and the port's factory-built nerfacto at TINY_MODEL with
    ``option``, the port's MLPs in float32, both at JAX's parameters with
    flat tables and over the same grid (None without the occupancy
    sampler). Returns (JAX pipeline, its params, its grid, the port's
    pipeline, its state, its config)."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.field_components.mlp import MLP
    from nerfstudio_torch.pipelines.factory import build_pipeline

    parser = dict(data=scene, eval_mode="interval", eval_interval=NUM_IMAGES + 1)
    jconfig = jget_method("nerfacto")
    jconfig.model = dataclasses.replace(jconfig.model, **TINY_MODEL, **option)
    jconfig.data, jconfig.dataparser = scene, JNerfstudio(**parser)
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    params = _flat(jax.device_get(jstate.params))
    config = get_method("nerfacto")
    config.data, config.dataparser = scene, NerfstudioDataParserConfig(**parser)
    config.machine.device_type = "cpu"
    config.datamanager.train_num_rays_per_batch = RAYS
    for k, v in {**TINY_MODEL, **option}.items():
        setattr(config.model, k, v)
    pipe, state, config = build_pipeline(config)
    model = pipe.model
    for m in model.modules():
        if isinstance(m, MLP):
            m.dtype = torch.float32
    model.load_state_dict(params_from_jax(params, model))
    grid = None
    if config.model.use_occupancy_sampler:
        grid = _grid(config.model.occ_grid_resolution)
        state.aux = occupancy_from_jax(grid)
    else:
        assert jstate.aux is None and state.aux is None and pipe.aux_update_fn is None
    return jpipe, params, grid, pipe, state, config


def _jax_step(jpipe, params, aux, key, kwargs):
    """(gradients, {"loss", its terms, the metrics}) of JAX's train step with
    its draws from ``key``, every MLP in float32."""
    from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices

    dm, jmodel = jpipe.datamanager, jpipe.model_train
    k_pix, k_model = jax.random.split(key)
    idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

    def loss_fn(p):
        outputs = jmodel.apply(p, generate_rays_from_indices(dm.train_cameras, idx), key=k_model, model_aux=aux,
                               **kwargs)
        metrics = jmodel.get_metrics_dict(outputs, batch, p)
        loss_dict = jmodel.get_loss_dict(outputs, batch, metrics, p, config=jmodel.config)
        return sum(loss_dict.values()), {**loss_dict, **metrics}

    with jax_float32_mlps():
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jax.device_get(grads), {"loss": loss, **jax.device_get(metrics)}


@pytest.mark.parametrize("option", OPTIONS, ids=list(OPTIONS))
def test_option_step_matches_jax(scene, option):
    """One step at 304 with the option (see the module docstring): the
    port's stack has JAX's nets, its ``step_kwargs`` equal JAX's, the loss
    and every term and metric within 2e-3, the gradients as stated."""
    jpipe, params, grid, pipe, state, config = _pair(scene, OPTIONS[option])
    model = pipe.model
    n_prop = len(model.proposal_networks)
    assert n_prop == jpipe.model_train.num_proposal_rounds() == {"two_proposal_nets": 2,
                                                                 "occupancy_pdf_alone": 0}.get(option, 1)
    kwargs = type(jpipe.model_train).step_kwargs(STEP, jpipe.model_train.config)
    assert type(model).step_kwargs(STEP, config.model) == kwargs
    state.step = STEP
    key = jax.random.PRNGKey(3)
    jgrads, jmetrics = _jax_step(jpipe, jax.tree_util.tree_map(jnp.asarray, params),
                                 None if grid is None else jax.tree_util.tree_map(jnp.asarray, grid), key, kwargs)
    jgrads = params_from_jax(jgrads, model)
    n_img, h, w = pipe.datamanager.train_images.shape[:3]
    tmetrics = pipe.train_step(state, draws=jax_step_draws(key, RAYS, n_img, h, w, n_rounds=n_prop + 1), **kwargs)
    assert set(tmetrics) - {"camera_opt_translation", "camera_opt_rotation"} == set(jmetrics) - {
        "camera_opt_translation", "camera_opt_rotation"}
    for k in ("loss", "rgb_loss", "interlevel_loss", "distortion_loss", "camera_opt_regularizer", "psnr"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=2e-3, atol=1e-7, err_msg=k)
    if n_prop == 0:
        assert float(tmetrics["interlevel_loss"]) == float(jmetrics["interlevel_loss"]) == 0.0
    for n, p in model.named_parameters():
        ref = jgrads[n].numpy().astype(np.float64)
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy().astype(np.float64)
        if n.endswith("hash_table"):
            F = 128 * got.shape[1] // 2 ** TINY_MODEL["log2_hashmap_size"]
            got, ref = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, ref))
            rel = 1e-2 if n.startswith("proposal_networks") else 1e-3
            np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=n)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * np.abs(ref).max() + 1e-10, err_msg=n)
    if option == "two_proposal_nets":  # both nets of the stack take a gradient
        for i in range(n_prop):
            assert float(np.abs(jgrads[f"proposal_networks.{i}.mlp_base.encoding.hash_table"].numpy()).max()) > 0
    assert torch.isfinite(torch.stack([v for v in tmetrics.values()])).all()
