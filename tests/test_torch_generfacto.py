"""generfacto in the port against the JAX package: the random cameras bit
for bit and their rays, the Lambertian shader, the model's outputs in
training and eval, its loss terms, one training step of the generative
pipeline at step 0 (density blob at 0.1) and past the taper (step 1200),
the position gradient of the flat hash grid without a table gradient, and
``scripts.train generfacto`` on the CPU.

Small sizes: the field at 4 levels (4..64, level 0 dense) of T = 2^9, F =
2, 8-wide MLPs (``SMALL_FIELD``, patched into both packages' generfacto
modules), 16^2 renders of 8 samples a ray. JAX's parameters (tables
redrawn in +-1) reach the port through ``params_from_jax``; JAX's draws
follow its key splits (``train_step``: k1, k2, k3; ``get_outputs``: k_s,
k_bg, k_light) and are handed in. The model and step comparisons hold
every MLP in float32 on both sides, as the other step tests do.

Tolerances, those of the nerfacto step tests: values 1e-4 absolute, the
loss terms 2e-3 relative, each gradient within 5e-2 of its peak; the
parameters after Adam in units of the learning rate (its first step moves
an entry by about the rate whatever its gradient's size)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, init_params, to_torch
import nerfstudio_tpu.models.generfacto as jgen_mod
import nerfstudio_tpu.pipelines.generative_pipeline as jpipe_mod
from nerfstudio_tpu.configs.method_configs import get_method as jget_method
from nerfstudio_tpu.data.random_cameras_datamanager import RandomCamerasConfig as JRandomCamerasConfig
from nerfstudio_tpu.data.random_cameras_datamanager import RandomCamerasDataManager as JRandomCameras
from nerfstudio_tpu.fields.nerfacto_field import NerfactoField as JNerfactoField
from nerfstudio_tpu.model_components.shaders import lambertian_shader as jlambertian
from nerfstudio_tpu.models.generfacto import GenerfactoModel as JGenerfactoModel
import nerfstudio_torch.models.generfacto as tgen_mod
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.data.random_cameras_datamanager import RandomCamerasConfig, RandomCamerasDataManager
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.model_components.shaders import lambertian_shader
from nerfstudio_torch.models.generfacto import GenerfactoDraws, GenerfactoModel
from nerfstudio_torch.ops import hash_grid
from nerfstudio_torch.pipelines.generative_pipeline import GenerativeDraws, GenerativePipeline
from nerfstudio_torch.utils.convert import params_from_jax, trainer_checkpoint_from_jax
from test_torch_instant_ngp import jax_float32_mlps

SMALL_FIELD = dict(num_levels=4, base_res=4, max_res=64, log2_hashmap_size=9, hidden_dim=8, hidden_dim_color=8)
RES, SAMPLES = 16, 8
VALUE_ATOL, LOSS_RTOL, GRAD_REL = 1e-4, 2e-3, 5e-2


@pytest.fixture
def small(monkeypatch):
    """Both packages' generfacto at SMALL_FIELD."""
    monkeypatch.setattr(jgen_mod, "NerfactoField", functools.partial(JNerfactoField, **SMALL_FIELD))
    monkeypatch.setattr(tgen_mod, "NerfactoField", functools.partial(NerfactoField, **SMALL_FIELD))


def _configs():
    jcfg, tcfg = jget_method("generfacto"), get_method("generfacto")
    for cfg, cams in ((jcfg, JRandomCamerasConfig), (tcfg, RandomCamerasConfig)):
        cfg.model.num_samples_per_ray = SAMPLES
        cfg.random_cameras = cams(train_resolution=RES, eval_resolution=RES)
    return jcfg, tcfg


def _port_f32(model):
    for m in model.modules():
        if isinstance(m, MLP):
            m.dtype = torch.float32


def _pipelines(seed=0):
    """JAX's pipeline and state (tables redrawn in +-1) and the port's at
    the same parameters, each having drawn its init camera; the port's MLPs
    in float32."""
    jcfg, tcfg = _configs()
    jpipe = jpipe_mod.GenerativePipeline(jcfg, seed=seed)
    init = jpipe.init_state(jax.random.PRNGKey(seed)).params
    params = init_params(lambda k: init, seed)
    jstate = jpipe_mod.GenerativeTrainState(params=params, opt_state=jpipe.tx.init(params),
                                            step=jnp.zeros((), jnp.int32))
    pipe = GenerativePipeline(tcfg, seed=seed, device=CPU)
    state = pipe.init_state(torch.Generator().manual_seed(seed))
    pipe.restore(state, trainer_checkpoint_from_jax(jax.device_get(jstate), pipe.model, state.optimizer))
    _port_f32(pipe.model)
    return jpipe, jstate, pipe, state


def _jax_rays(cams):
    rb = cams.generate_rays(camera_indices=0)
    return jax.tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]) if x is not None else None, rb)


def _port_rays(jrb):
    return RayBundle(origins=to_torch(jrb.origins), directions=to_torch(jrb.directions),
                     pixel_area=to_torch(jrb.pixel_area), camera_indices=to_torch(jrb.camera_indices))


def _render_draws(key, rays):
    """GenerfactoDraws holding what JAX's get_outputs draws from ``key``."""
    k_s, k_bg, k_light = jax.random.split(key, 3)
    return GenerfactoDraws(jitter=to_torch(jax.random.uniform(k_s, (rays, 1))),
                           background=to_torch(jax.random.uniform(k_bg, (rays, 3))),
                           light=to_torch(jax.random.normal(k_light, (3,))))


# --------------------------------------------------------------------------
# cameras and shading


def test_random_cameras_match_jax():
    """20 training cameras and the 8 eval cameras equal JAX's bit for bit
    (poses, intrinsics, sizes, the drawn angles); their rays within 1e-6."""
    cfg = dict(train_resolution=RES, eval_resolution=24)
    jdm, tdm = JRandomCameras(JRandomCamerasConfig(**cfg), seed=3), RandomCamerasDataManager(
        RandomCamerasConfig(**cfg), seed=3, device=CPU)
    pairs = []
    for step in range(20):
        (jc, jv, jh), (tc, tv, th) = jdm.next_train(step), tdm.next_train(step)
        assert (jv, jh) == (tv, th)
        pairs.append((jc, tc))
    jev, tev = jdm.eval_cameras(), tdm.eval_cameras()
    assert len(jev) == len(tev) == 8
    pairs += list(zip(jev, tev))
    for jc, tc in pairs:
        for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height"):
            want = np.asarray(getattr(jc, f))
            got = getattr(tc, f).numpy()
            assert np.array_equal(got.reshape(want.shape), want), f
        jrb, trb = jc.generate_rays(camera_indices=0), tc.generate_rays(camera_indices=0)
        for f in ("origins", "directions", "pixel_area"):
            np.testing.assert_allclose(getattr(trb, f).numpy(), np.asarray(getattr(jrb, f)), rtol=0, atol=1e-6,
                                       err_msg=f)


@pytest.mark.parametrize("detach", [True, False])
def test_lambertian_shader_matches_jax(detach):
    """Values within 1e-7, and the normals' gradient stopped with ``detach_normals``."""
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    n = rng.normal(size=(50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    light = np.array([0.3, -0.5, 0.8], np.float32)
    want = np.asarray(jlambertian(rgb, n, light, shading_weight=0.7, detach_normals=detach))
    tn = to_torch(n).requires_grad_(True)
    got = lambertian_shader(to_torch(rgb), tn, to_torch(light), shading_weight=0.7, detach_normals=detach)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-7)
    assert got.requires_grad != detach


# --------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_get_outputs_match_jax(small, train):
    """One 16^2 training camera's rays through both models: in training
    with JAX's draws handed in (the jitter, the random background, the
    light) and the density blob at 0.1, rgb, accumulation, expected depth,
    normals and the shaded render; at eval (no key: the bin edges over
    white, no shading) the same without ``shaded``. All within 1e-4."""
    jpipe, jstate, pipe, _ = _pipelines()
    cams, _, _ = jpipe.datamanager.next_train(0)
    jrb = _jax_rays(cams)
    key = jax.random.PRNGKey(11)
    jmodel = JGenerfactoModel(config=jpipe.model_cfg, scene_aabb=((-1.0,) * 3, (1.0,) * 3), num_train_data=1,
                              train=train)
    with jax_float32_mlps():
        want = jmodel.apply(jstate.params, jrb, key=key if train else None, density_strength=0.1)
    model = pipe.model.train(train)
    with torch.set_grad_enabled(train):
        got = model(_port_rays(jrb), density_strength=0.1,
                    draws=_render_draws(key, RES * RES) if train else None)
    keys = {"rgb", "accumulation", "depth", "normals"} | ({"shaded"} if train else set())
    assert set(got) == set(want) == keys
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0, atol=VALUE_ATOL, err_msg=k)
    acc = got["accumulation"].detach()
    assert float(acc.min()) < 0.5 < float(acc.max())
    assert float(got["normals"].detach().norm(dim=-1).max()) > 0.99


def test_loss_dict_matches_jax():
    """The surrogate SDS term and the opacity term (with its 0-weighted log,
    accumulation 0 and 1 included) within 1e-6 relative."""
    rng = np.random.default_rng(1)
    rgb = rng.uniform(size=(64, 3)).astype(np.float32)
    acc = np.concatenate([[0.0, 1.0, 1e-7], rng.uniform(size=61)]).astype(np.float32)[:, None]
    sds = rng.normal(size=(64, 3)).astype(np.float32) * 1e-3
    cfg = jget_method("generfacto").model
    want = JGenerfactoModel.get_loss_dict({"rgb": rgb, "accumulation": acc}, {"sds_grad": sds}, config=cfg)
    got = GenerfactoModel.get_loss_dict({"rgb": to_torch(rgb), "accumulation": to_torch(acc)},
                                        {"sds_grad": to_torch(sds)}, get_method("generfacto").model)
    assert set(got) == set(want) == {"sds_loss", "opacity_loss"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    for step in (0, 250, 1000, 1200):
        assert GenerfactoModel.step_kwargs(step, get_method("generfacto").model) == pytest.approx(
            JGenerfactoModel.step_kwargs(step, cfg))


# --------------------------------------------------------------------------
# one training step


def _jax_step(jpipe, jstate, step, key):
    """JAX's train_step at ``step`` (MLPs in float32): (its new state, its
    metrics, the image its guidance saw, the update's gradients at the
    old parameters)."""
    seen = {}
    guidance = jpipe.guidance.sds_grad

    def spy(k, rgb, *a, **kw):
        seen["rgb"] = np.asarray(rgb)
        return guidance(k, rgb, *a, **kw)

    jpipe.guidance.sds_grad = spy
    jpipe._build(RES)
    update = jpipe._update

    def record(state, rb, k1, sds_grad, density_strength):
        seen.update(rb=rb, k1=k1, sds_grad=sds_grad, density_strength=density_strength)
        return update(state, rb, k1, sds_grad, density_strength)

    jpipe._update = record
    model = jpipe.model
    with jax_float32_mlps():
        new_state, metrics = jpipe.train_step(jstate, step, key)

        def loss_fn(params):
            out = model.apply(params, seen["rb"], key=seen["k1"], density_strength=seen["density_strength"])
            loss_dict = model.get_loss_dict(out, {"sds_grad": seen["sds_grad"].reshape(-1, 3)}, None, params,
                                            config=model.config)
            return sum(loss_dict.values())

        grads = jax.jit(jax.grad(loss_fn))(jstate.params)
    return new_state, jax.device_get(metrics), seen["rgb"], jax.device_get(grads)


@pytest.fixture(params=[0, 1200], ids=["step0", "step1200"])
def step_pair(request, small):
    step = request.param
    jpipe, jstate, pipe, state = _pipelines()
    key = jax.random.PRNGKey(step + 7)
    new_jstate, jmetrics, jrgb, jgrads = _jax_step(jpipe, jstate, step, key)
    k1, k2, _ = jax.random.split(key, 3)
    draws = GenerativeDraws(model=_render_draws(k1, RES * RES), sds_noise=to_torch(jax.random.normal(k2, (RES, RES, 3))))
    draws.model.light = None  # the step renders no shading
    seen = {}
    guidance = pipe.guidance.sds_grad

    def spy(rgb, *a, **kw):
        seen["rgb"] = rgb.clone()
        return guidance(rgb, *a, **kw)

    pipe.guidance.sds_grad = spy
    calls = []
    twin_bwd = hash_grid._flat_twin_bwd

    def count(*a, **kw):
        calls.append({k: kw[k] for k in ("need_positions", "need_table")})
        return twin_bwd(*a, **kw)

    hash_grid._flat_twin_bwd = count
    try:
        metrics = pipe.train_step(state, step, draws=draws)
    finally:
        hash_grid._flat_twin_bwd = twin_bwd
    return dict(step=step, pipe=pipe, state=state, metrics=metrics, rgb=seen["rgb"], calls=calls,
                jstate=new_jstate, jmetrics=jmetrics, jrgb=jrgb, jgrads=jgrads)


def test_step_renders_and_losses_match_jax(step_pair):
    """The image the guidance saw within 1e-4, the loss and its two terms
    within 2e-3 relative, the step counted; K7's backward ran once, for
    the table gradient alone."""
    r = step_pair
    np.testing.assert_allclose(r["rgb"].numpy(), r["jrgb"], rtol=0, atol=VALUE_ATOL)
    assert set(r["metrics"]) == set(r["jmetrics"]) == {"loss", "sds_loss", "opacity_loss"}
    for k in r["metrics"]:
        np.testing.assert_allclose(float(r["metrics"][k]), float(r["jmetrics"][k]), rtol=LOSS_RTOL, err_msg=k)
    assert r["state"].step == int(r["jstate"].step) == 1
    assert r["calls"] == [{"need_positions": False, "need_table": True}]


def test_step_gradients_match_jax(step_pair):
    """Every parameter's gradient within 5e-2 of its peak (the table entry
    by entry: K7 is the exact trilerp on both sides)."""
    model = step_pair["pipe"].model
    jg = params_from_jax(step_pair["jgrads"], model)
    assert set(jg) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        ref = jg[n].numpy().astype(np.float64)
        got = p.grad.numpy().astype(np.float64)
        peak = np.abs(ref).max()
        assert peak > 0, n
        np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_REL * peak, err_msg=n)


def test_step_parameters_after_adam_match_jax(step_pair):
    """The parameters after the step's Adam update, in units of its rate
    (1e-2): each entry within 0.1 and every tensor's mean gap within 0.01;
    the entries with no gradient unmoved on both sides."""
    model = step_pair["pipe"].model
    jp = params_from_jax(jax.device_get(step_pair["jstate"].params), model)
    for n, p in model.named_parameters():
        gap = np.abs(p.detach().numpy() - jp[n].numpy()) / 1e-2
        assert gap.max() <= 0.1 and gap.mean() <= 0.01, (n, gap.max(), gap.mean())


# --------------------------------------------------------------------------
# the eval normals' position gradient, and the CLI


def test_position_gradient_alone_computes_no_table_gradient():
    """``autograd.grad`` of a K7 encoding in the positions alone, the table
    a parameter: the backward is asked for no table gradient (the twin's
    ``need_table``), and the position gradient equals the one taken beside
    the table's."""
    rng = np.random.default_rng(5)
    table = torch.nn.Parameter(hash_grid.init_hash_table(4, 2**9, 2, 1.0, device=CPU))
    kw = dict(num_levels=4, min_res=4, max_res=64, hash_table_size=2**9)
    g = to_torch(rng.normal(size=(300, 8)).astype(np.float32))

    def pos_grad(inputs):
        pos = to_torch(rng.uniform(0.05, 0.95, (300, 3)).astype(np.float32)) if not inputs else inputs[0]
        pos = pos.detach().requires_grad_(True)
        out = hash_grid.hash_encode(pos, table, **kw)
        return pos, torch.autograd.grad((out * g).sum(), [pos] + ([table] if inputs else []))

    calls = []
    twin_bwd = hash_grid._flat_twin_bwd

    def spy(*a, **k):
        calls.append((k["need_positions"], k["need_table"]))
        return twin_bwd(*a, **k)

    hash_grid._flat_twin_bwd = spy
    try:
        pos, (alone,) = pos_grad(())
        _, (both, d_table) = pos_grad((pos,))
    finally:
        hash_grid._flat_twin_bwd = twin_bwd
    assert calls == [(True, False), (True, True)]
    assert torch.equal(alone, both) and float(alone.abs().max()) > 0 and d_table.abs().max() > 0


def test_eval_render_asks_positions_alone(small):
    """``render_eval_image``: every output as (16, 16, C) and finite, the
    normals from one K7 backward with the position gradient alone."""
    _, _, pipe, state = _pipelines()
    calls = []
    twin_bwd = hash_grid._flat_twin_bwd

    def spy(*a, **k):
        calls.append((k["need_positions"], k["need_table"]))
        return twin_bwd(*a, **k)

    hash_grid._flat_twin_bwd = spy
    try:
        out = pipe.render_eval_image(state, 3)
    finally:
        hash_grid._flat_twin_bwd = twin_bwd
    assert calls == [(True, False)]
    assert {k: tuple(v.shape) for k, v in out.items()} == {"rgb": (RES, RES, 3), "accumulation": (RES, RES, 1),
                                                          "depth": (RES, RES, 1), "normals": (RES, RES, 3)}
    assert all(torch.isfinite(v).all() for v in out.values()) and pipe.model.training


def test_train_cli_on_the_cpu(small, tmp_path, monkeypatch, capsys):
    """``scripts.train generfacto`` on the CPU for 2 steps with no --data:
    the config (JSON and pickle), the loss logged at step 0, one
    checkpoint at step 2 that the pipeline restores, the stub's warning."""
    import nerfstudio_torch.pipelines.generative_pipeline as tpipe_mod
    from nerfstudio_torch.engine.trainer import read_checkpoint
    from nerfstudio_torch.scripts import train

    monkeypatch.setattr(tpipe_mod, "RandomCamerasConfig",
                        functools.partial(RandomCamerasConfig, train_resolution=RES, eval_resolution=RES))
    train.main(["generfacto", "--machine.device_type", "cpu", "--trainer.max_num_iterations", "2",
                "--trainer.output_dir", str(tmp_path), "--trainer.timestamp", "run",
                "--model.num_samples_per_ray", str(SAMPLES), "--trainer.vis", "none"])
    run = tmp_path / "unnamed" / "generfacto" / "run"
    cfg = json.loads((run / "config.yml").read_text())
    assert cfg["method_name"] == "generfacto" and cfg["model"]["num_samples_per_ray"] == SAMPLES
    assert (run / "config.pkl").is_file()
    logged = [json.loads(line) for line in (run / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [0] and set(logged[0]) >= {"loss", "sds_loss", "opacity_loss"}
    step, payload = read_checkpoint(run / "nerfstudio_models")
    assert step == 2 and payload["optimizer"]["count"] == 2
    pipe = GenerativePipeline(get_method("generfacto"), device=CPU)
    state = pipe.init_state()
    pipe.restore(state, payload)
    assert state.step == 2
    out = capsys.readouterr()
    assert "falling back to STUB guidance" in out.err and "training finished" in out.out
