"""nerfacto-big and nerfacto-huge in the port against the JAX reference:
their parameter trees at the shipped widths (``params_from_jax`` with every
width checked), their per-step schedules, and one training step of each
factory-built pipeline with JAX's draws handed in, at the shipped widths
with the hash tables cut to T = 2^12 and 64 rays; the SDF field's
appearance embedding through the same conversion.

The step follows test_torch_capture_steps: flat hash tables, the loss and
its terms to 2e-3, each non-table gradient within 5e-2 of its largest
entry, each table's gradient summed per level and feature within 1e-3 of
the largest such sum (the proposal table's 1e-2). The field's MLP biases
are held to JAX's gradient with every MLP in float32 (the density MLP's
too, at these widths): a bias gradient sums every sample's cotangent, and
JAX's bfloat16 products round that sum farther from its own float32 value
than the port's do (asserted)."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import CPU, NUM_IMAGES, jax_step_draws
from fixtures import make_nerfstudio_fixture
from test_torch_convert import _jax_rays
from test_torch_train_step import _flat_tables
from test_torch_trainer import RAYS, _config, _jax_grads
import functools
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.utils.convert import params_from_jax, trainer_checkpoint_from_jax

HW = 16
STEP = 303  # live proposals, the full field backward, no occupancy update (303 % 16 != 0)
LOG2_T = 12


def _cut(model_cfg):
    """The model config with every hash table cut to 2^LOG2_T entries and
    nothing else changed."""
    args = tuple(dict(a, log2_hashmap_size=LOG2_T) for a in model_cfg.proposal_net_args_list)
    return dataclasses.replace(model_cfg, log2_hashmap_size=LOG2_T, proposal_net_args_list=args)


@pytest.mark.parametrize("method, field_shape, prop_shape, hidden", [
    ("nerfacto-big", (8, 2**21 * 4 // 128, 128), (5, 2**17 * 2 // 128, 128), 128),
    ("nerfacto-huge", (16, 2**21 * 4 // 128, 128), (7, 2**17 * 2 // 128, 128), 256),
])
def test_full_width_tree_converts_with_no_leftover(method, field_shape, prop_shape, hidden):
    """The shipped tree (shapes from jax.eval_shape, so no JAX compute): the
    field's L x T x F table (T = 2^21: 256 MiB for big, 512 MiB for huge),
    the one proposal net the occupancy path keeps (the last of the args
    list: L5 for big, L7 for huge), the MLP widths, every leaf on exactly
    one port parameter."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto
    from nerfstudio_torch.configs.method_configs import get_method

    jmodel = JNerfacto(config=jget_method(method).model, num_train_data=8, train=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), _jax_rays(), key=None))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = get_method(method).model.setup(num_train_data=8, device=CPU)
    state = params_from_jax(tree, model)
    model.load_state_dict(state, strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_jax == sum(p.numel() for p in model.parameters())
    assert model.field.mlp_base.encoding.hash_table.shape == field_shape
    assert model.proposal_networks[0].mlp_base.encoding.hash_table.shape == prop_shape
    assert len(model.proposal_networks) == 1
    widths = {p.shape[0] for n, p in model.field.named_parameters() if n.endswith("weight") and p.ndim == 2}
    assert hidden in widths and model.field.embedding_appearance.embedding.weight.shape == (8, 32)


def test_sdf_appearance_embedding_converts():
    """plain neus with the appearance embedding: the SDF field's
    ``embedding_appearance`` (one 32-wide code per train image) lands on the
    port's, with the rest of the tree."""
    from nerfstudio_tpu.models.neus import NeuSModel as JNeuS
    from nerfstudio_tpu.models.neus import NeuSModelConfig as JNeuSConfig
    from nerfstudio_torch.models.neus import NeuSModelConfig

    jmodel = JNeuS(config=JNeuSConfig(use_appearance_embedding=True), num_train_data=8, train=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), _jax_rays(), key=jax.random.PRNGKey(1)))
    tree = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.25, s.dtype), shapes)
    model = NeuSModelConfig(use_appearance_embedding=True).setup(num_train_data=8, device=CPU)
    state = params_from_jax(tree, model)
    model.load_state_dict(state, strict=True)
    assert state["field.embedding_appearance.embedding.weight"].shape == (8, 32)
    assert model.field.clin[0].weight.shape[1] == 3 + 27 + 3 + 256 + 32


@pytest.mark.parametrize("method", ["nerfacto-big", "nerfacto-huge"])
def test_step_kwargs_match_jax(method):
    """The schedule the trainer hands each step (proposal anneal, proposal
    updates and freeze at 8000, the field's level-subsampled backward from
    512 at period 2) equals the reference's at the shipped config."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.models.nerfacto import NerfactoModel

    jcfg, cfg = jget_method(method).model, get_method(method).model
    for step in (0, 1, 5, 255, 511, 512, 513, 1499, 2999, 5000, 7999, 8000, 8001, 99999):
        want = {k: (tuple(v) if isinstance(v, (list, tuple)) else v) for k, v in
                JNerfacto.step_kwargs(step, jcfg).items()}
        got = {k: (tuple(v) if isinstance(v, (list, tuple)) else v) for k, v in
               NerfactoModel.step_kwargs(step, cfg).items()}
        assert got.keys() == want.keys(), step
        for k in got:
            assert got[k] == pytest.approx(want[k]) if isinstance(got[k], float) else got[k] == want[k], (step, k)


def _jax_grads_float32(jpipe, params, aux, key, kwargs):
    """``_jax_grads`` with the field's colour head and every hash-encoded
    MLP (the density MLP's, the proposal net's) in float32."""
    import nerfstudio_tpu.field_components.mlp as jmlp

    mlp = jmlp.MLP
    jmlp.MLP = functools.partial(mlp, dtype=jax.numpy.float32)
    try:
        return _jax_grads(jpipe, params, aux, key, kwargs, head_float32=True)
    finally:
        jmlp.MLP = mlp


def _pipelines(method, scene):
    """JAX's and the port's factory-built ``method`` at its shipped widths
    with the tables cut (``_cut``), frame 0 held out, JAX's params (flat
    tables) and occupancy grid restored into the port."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.pipelines.factory import build_pipeline

    jconfig = jget_method(method)
    jconfig.model = _cut(jconfig.model)
    jconfig.data = scene
    jconfig.dataparser.eval_mode, jconfig.dataparser.eval_interval = "interval", NUM_IMAGES + 1
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    params = _flat_tables(jax.device_get(jstate.params), (LOG2_T, LOG2_T))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jax.numpy.asarray, params))
    config = _config(method, scene, Path("unused"), 1)
    config.model = _cut(config.model)
    pipe, state, config = build_pipeline(config)
    ttrainer.restore_train_state(pipe, state, trainer_checkpoint_from_jax(jax.device_get(jstate), pipe.model,
                                                                          state.optimizer))
    return jpipe, jstate, jconfig, pipe, state, config


@pytest.mark.parametrize("method", ["nerfacto-big", "nerfacto-huge"])
def test_step_matches_jax(tmp_path, method):
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto

    scene = make_nerfstudio_fixture(tmp_path / "scene", n=NUM_IMAGES + 1, hw=HW)
    jpipe, jstate, jconfig, pipe, state, config = _pipelines(method, scene)
    model = pipe.model
    assert model.field.mlp_base.encoding.num_levels == jconfig.model.num_levels
    assert config.model.hidden_dim == jconfig.model.hidden_dim and config.model.num_levels == jconfig.model.num_levels
    jstate = jstate.replace(step=jax.numpy.asarray(STEP, jax.numpy.int32))
    state.step = STEP
    kwargs = JNerfacto.step_kwargs(STEP, jconfig.model)
    assert kwargs["update_proposals"] and kwargs.get("field_bwd_levels") is None
    k_step = jax.random.PRNGKey(11)
    jgrads = params_from_jax(_jax_grads(jpipe, jstate.params, jstate.aux, k_step, kwargs), model)
    jgrads32 = params_from_jax(_jax_grads_float32(jpipe, jstate.params, jstate.aux, k_step, kwargs), model)
    jstate, jmetrics = jpipe.train_step(jstate, jpipe.datamanager.train_images, k_step, **kwargs)
    tmetrics = pipe.train_step(state, draws=jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW), **kwargs)
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
            F = 128 * got.shape[1] // 2**LOG2_T
            got, ref = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, ref))
            rel = 1e-2 if n.startswith("proposal_networks") else 1e-3
            np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=n)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * np.abs(ref).max() + 1e-10, err_msg=n)
    assert off_float32["port"] < off_float32["jax"], off_float32
    assert torch.isfinite(torch.stack([v for v in tmetrics.values()])).all()
