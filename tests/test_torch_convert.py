"""params_from_jax / occupancy_from_jax: every JAX leaf lands on exactly one
port parameter, with dense kernels transposed and hash tables unchanged; a
JAX instant-ngp train state becomes a port checkpoint that renders as JAX
does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, NUM_IMAGES, init_params, jax_tiny_nerfacto, torch_tiny_nerfacto
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_torch.utils.convert import occupancy_from_jax, params_from_jax


def _jax_rays(n=4):
    o = np.zeros((n, 3), np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    return JRayBundle(origins=o, directions=d, pixel_area=np.ones((n, 1), np.float32),
                      camera_indices=np.zeros((n, 1), np.int32))


def test_full_width_nerfacto_tree_converts_with_no_leftover():
    """The shipped nerfacto width (18.1M parameters, and the 8 x 6 camera-opt
    tangents a training model adds): shapes from jax.eval_shape, so no JAX
    compute is needed."""
    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto
    from nerfstudio_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig

    jmodel = JNerfacto(config=get_method("nerfacto").model, num_train_data=8, train=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), _jax_rays(), key=None))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = NerfactoModel(NerfactoModelConfig(eval_num_rays_per_chunk=1 << 15), num_train_data=8, device=CPU)
    state = params_from_jax(tree, model)
    model.load_state_dict(state, strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_jax == sum(p.numel() for p in model.parameters()) == 18_099_988 + 8 * 6
    assert state["camera_optimizer.pose_adjustment"].shape == (8, 6)
    assert model.field.mlp_base.encoding.hash_table.shape == (8, 16384, 128)
    assert model.proposal_networks[0].mlp_base.encoding.hash_table.shape == (5, 2048, 128)


@pytest.fixture(scope="module")
def tiny_params():
    jmodel, _ = jax_tiny_nerfacto()
    return init_params(lambda k: jmodel.init(k, _jax_rays(), key=None), 0)


def test_full_width_neus_facto_tree_converts_with_no_leftover():
    """The shipped neus-facto (an 8x256 weight-normed SDF net with its skip,
    a 4x256 colour net, the learned variance and two flat-layout L5 F2
    T=2^17 proposal nets), shapes from jax.eval_shape: kernels transposed
    beside their scales, the flat tables kept as (L, S, 128), the variance a
    scalar."""
    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.models.neus import NeuSFactoModel as JNeuSFacto
    from nerfstudio_torch.models.neus import NeuSFactoModelConfig

    jmodel = JNeuSFacto(config=get_method("neus-facto").model, num_train_data=8, train=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), _jax_rays(), key=None))
    tree = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, s.dtype), shapes)
    model = NeuSFactoModelConfig().setup(num_train_data=8, device=CPU)
    state = params_from_jax(tree, model)
    model.load_state_dict(state, strict=True)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_jax == sum(p.numel() for p in model.parameters())
    assert model.field.skips == (4,) and state["field.glin.3.weight"].shape == (256 - 39, 256)
    assert state["field.glin.4.weight"].shape == (256, 256) and state["field.glin.0.scale"].shape == (256,)
    assert state["field.deviation_network.variance"].shape == ()
    for i in range(2):
        table = state[f"proposal_networks.{i}.mlp_base.encoding.hash_table"]
        assert table.shape == (5, 2**17 * 2 // 128, 128) and bool((table == 0.5).all())
    leaf = tree["params"]["field"]["glin_0"]["kernel"]
    assert state["field.glin.0.weight"].shape == leaf.shape[::-1]


def test_kernels_transposed_tables_and_embeddings_kept(tiny_params):
    model = torch_tiny_nerfacto()
    state = params_from_jax(tiny_params, model)
    p = tiny_params["params"]
    np.testing.assert_array_equal(
        state["field.mlp_head.layers.0.weight"].numpy(), p["field"]["mlp_head"]["layers_0"]["kernel"].T
    )
    np.testing.assert_array_equal(
        state["proposal_networks.0.mlp_base.mlp.layers.1.bias"].numpy(),
        p["proposal_networks_0"]["mlp_base"]["mlp"]["layers_1"]["bias"],
    )
    np.testing.assert_array_equal(
        state["field.mlp_base.encoding.hash_table"].numpy(), p["field"]["mlp_base"]["encoding"]["hash_table"]
    )
    emb = state["field.embedding_appearance.embedding.weight"]
    assert emb.shape == (NUM_IMAGES, 8)
    model.load_state_dict(state, strict=True)


def test_leftovers_on_either_side_raise(tiny_params):
    model = torch_tiny_nerfacto()
    p = jax.tree_util.tree_map(np.asarray, tiny_params)["params"]
    extra = {**p, "field": {**p["field"], "mlp_extra": {"layers_0": {"bias": np.zeros(3, np.float32)}}}}
    with pytest.raises(ValueError, match="left over"):
        params_from_jax(extra, model)
    missing = {**p, "field": {k: v for k, v in p["field"].items() if k != "mlp_head"}}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(missing, model)
    unknown = {**p, "field": {**p["field"], "scale": np.ones(1, np.float32)}}
    with pytest.raises(ValueError, match="no port parameter"):
        params_from_jax(unknown, model)
    other_collection = {"params": p, "batch_stats": {"mean": np.zeros(1, np.float32)}}
    with pytest.raises(ValueError):
        params_from_jax(other_collection, model)


def _jax_splat_state():
    """A JAX SplatTrainState at 64 slots after one optax update (nonzero
    moments, count 1), as numpy leaves."""
    import optax

    from nerfstudio_tpu.models.splatfacto import SplatfactoModelConfig, init_gaussian_params
    from nerfstudio_tpu.pipelines.splat_pipeline import SplatTrainState, build_splat_optimizers

    cfg = SplatfactoModelConfig(max_gaussians=64, num_random=40, random_init=True, sh_degree=2)
    params, aux = init_gaussian_params(cfg)
    tx = build_splat_optimizers(cfg, max_steps=100)
    rng = np.random.default_rng(0)
    grads = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in params.items()}
    updates, opt_state = tx.update(grads, tx.init(params), params)
    aux = aux.replace(grad_accum=jnp.asarray(rng.uniform(size=64).astype(np.float32)))
    state = SplatTrainState(params=optax.apply_updates(params, updates), opt_state=opt_state, aux=aux,
                            step=jnp.asarray(1, jnp.int32))
    return jax.device_get(state), cfg


def test_splat_state_from_jax_round_trip():
    """Params, aux and each array's (count, mu, nu) land unchanged, and the
    port's pipeline takes them whole."""
    from nerfstudio_torch.models.splatfacto import SplatfactoModel, SplatfactoModelConfig
    from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline
    from nerfstudio_torch.utils.convert import splat_state_from_jax

    jstate, cfg = _jax_splat_state()
    params, aux, moments, step = splat_state_from_jax(jstate)
    assert step == 1
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v))
        count, mu, nu = moments[k]
        adam = jstate.opt_state.inner_states[k].inner_state[0]
        assert count == 1
        np.testing.assert_array_equal(mu.numpy(), np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(nu.numpy(), np.asarray(adam.nu[k]))
    assert aux.alive.dtype == torch.bool and int(aux.alive.sum()) == 40
    np.testing.assert_array_equal(aux.grad_accum.numpy(), np.asarray(jstate.aux.grad_accum))
    port_cfg = SplatfactoModelConfig(max_gaussians=64, num_random=40, random_init=True, sh_degree=2)
    st = SplatPipeline(None, SplatfactoModel(port_cfg), max_steps=100).state_from(params, aux, moments, step)
    assert st.optimizer.count == 1 and st.step == 1
    s = st.optimizer.optimizer.state[st.params["means"]]
    np.testing.assert_array_equal(s["exp_avg"].numpy(), moments["means"][1].numpy())


def test_splat_state_from_jax_rejects_mismatches():
    from nerfstudio_torch.models.splatfacto import SplatfactoModel, SplatfactoModelConfig
    from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline
    from nerfstudio_torch.utils.convert import splat_state_from_jax

    jstate, _ = _jax_splat_state()
    extra = jstate.replace(params={**jstate.params, "appearance": np.zeros((4, 6), np.float32)})
    with pytest.raises(ValueError, match="splat params"):
        splat_state_from_jax(extra)
    missing = jstate.replace(params={k: v for k, v in jstate.params.items() if k != "quats"})
    with pytest.raises(ValueError, match="splat params"):
        splat_state_from_jax(missing)
    params, aux, moments, step = splat_state_from_jax(jstate)
    pipeline = SplatPipeline(None, SplatfactoModel(SplatfactoModelConfig(max_gaussians=64)), max_steps=100)
    with pytest.raises(ValueError, match="counts"):
        pipeline.state_from(params, aux, {**moments, "means": (2,) + moments["means"][1:]}, step)


def test_occupancy_from_jax():
    jgrid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), 8)
    dens = np.random.default_rng(0).uniform(0, 1, 8**3).astype(np.float32)
    jgrid = jgrid.replace(densities=jnp.asarray(dens), binary=jnp.asarray(dens > 0.5),
                          binary_rows=jocc._pack_rows(jnp.asarray(dens > 0.5), 8),
                          density_rows=jocc._pack_rows(jnp.asarray(dens), 8))
    grid = occupancy_from_jax(jgrid)
    assert grid.resolution == 8 and grid.binary.dtype == torch.bool
    np.testing.assert_array_equal(grid.binary.numpy(), dens > 0.5)
    np.testing.assert_array_equal(grid.densities.numpy(), dens)
    fields = {k: getattr(jgrid, k) for k in ("densities", "binary", "binary_rows", "density_rows", "aabb", "resolution")}
    with pytest.raises(ValueError, match="missing"):
        occupancy_from_jax({k: v for k, v in fields.items() if k != "aabb"})
    with pytest.raises(ValueError, match="packed view"):
        occupancy_from_jax({**fields, "density_rows": np.zeros((64, 128), np.float32)})


def test_instant_ngp_checkpoint_converts_and_renders_the_same_view(tmp_path):
    """A JAX instant-ngp train state after one train step over a refreshed
    grid (live tables, Adam moments and count 1) becomes the port's
    checkpoint: the field alone, every Adam moment and the count, the grid
    with its row-packed views dropped, the step. Restored into the port it
    renders a test view as JAX does (rgb, accumulation and depth within
    1e-4, the MLPs in float32 on both sides)."""
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_instant_ngp import _build, _widen, jax_float32_mlps
    from nerfstudio_torch.engine import trainer as ttrainer
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    scene = tmp_path / "blender"
    subprocess.run([sys.executable, str(Path(__file__).resolve().parent.parent / "tools" / "make_synthetic_dataset.py"),
                    str(scene), "--scene", "blender", "--hw", "16", "--n-train", "4", "--n-test", "2", "--n-points",
                    "100"], check=True, capture_output=True, timeout=300)
    jpipe, host_state, _, pipe, state, _ = _build("instant-ngp", scene)
    jstate = jax.tree_util.tree_map(jnp.asarray, host_state.replace(params=_widen(host_state.params, 7, flat=False)))
    with jax_float32_mlps():
        jstate = jpipe.aux_update_fn(jstate.replace(step=jnp.asarray(256, jnp.int32)), 256, jax.random.PRNGKey(1))
        jstate, _ = jpipe.train_step(jstate, jpipe.datamanager.train_images, jax.random.PRNGKey(2))
    host = jax.device_get(jstate)
    payload = trainer_checkpoint_from_jax(host, pipe.model, state.optimizer)
    assert set(payload["model"]) == {k for k, _ in pipe.model.named_parameters()}
    assert all(k.startswith("field.") for k in payload["model"]) and payload["step"] == 257
    assert payload["optimizer"]["count"] == 1 and set(payload["optimizer"]["optimizers"]) == {"field"}
    assert set(payload["aux"]) == {"densities", "binary", "aabb", "resolution"}
    ttrainer.write_checkpoint(tmp_path / "ckpt", 257, payload)
    ttrainer.restore_train_state(pipe, state, ttrainer.read_checkpoint(tmp_path / "ckpt")[1])
    np.testing.assert_array_equal(state.aux.binary.numpy(), np.asarray(host.aux.binary))
    assert 0.0 < float(state.aux.binary.float().mean()) < 1.0
    mu = state.optimizer.state_dict()["optimizers"]["field"]["state"]
    assert all(float(v["step"]) == 1.0 and float(v["exp_avg"].abs().max()) > 0 for v in mu.values())
    cam_idx = pipe.datamanager.eval_image(0)[0]
    with jax_float32_mlps():
        want = jpipe.render_camera(jstate.params, jpipe.datamanager.eval_cameras, cam_idx, 128, aux=jstate.aux)
    got = pipe.render_eval_camera(state, cam_idx, 128)
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)
