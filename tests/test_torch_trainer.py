"""The port's trainer on the CPU: a run of 2N steps equals N steps, a
checkpoint, a resume and N more, bit for bit, for nerfacto (through the
occupancy updates) and splatfacto (across refines); the eval and save
cadence of JAX's ``Trainer``; one step of the factory-built pipeline on a
scene from disk against JAX's factory-built step with JAX's draws handed
in; a JAX train state resumed in the port."""

import dataclasses
import functools
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port import CPU, NUM_IMAGES, TINY_MODEL, jax_occupancy_draws, jax_step_draws
from fixtures import make_nerfstudio_fixture
from test_torch_train_step import _flat_tables
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.pipelines.factory import build_trainer
from nerfstudio_torch.pipelines.splat_pipeline import train_splat
from nerfstudio_torch.utils.convert import params_from_jax, trainer_checkpoint_from_jax

HW = 16
# the tiny nerfacto, its occupancy grid updated from step 2 every 2 steps
TINY_RUN = dict(TINY_MODEL, occ_warmup_steps=2, occ_update_every=2, occ_cells_per_update=1024,
                eval_num_rays_per_chunk=256)
RAYS = 64


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_nerfstudio_fixture(tmp_path_factory.mktemp("scene") / "ns", n=NUM_IMAGES + 1, hw=HW)


def _config(method, scene, out: Path, steps: int, **model):
    config = get_method(method)
    config.data = scene
    config.machine.device_type = "cpu"
    config.dataparser.eval_mode = "interval"
    config.dataparser.eval_interval = NUM_IMAGES + 1  # frame 0 held out, NUM_IMAGES to train
    t = config.trainer
    t.output_dir, t.experiment_name, t.timestamp, t.vis = out, "run", "t", "none"
    t.max_num_iterations, t.steps_per_eval_batch, t.steps_per_eval_image, t.steps_per_eval_all_images = steps, 0, 0, 0
    config.datamanager.train_num_rays_per_batch = RAYS
    for k, v in model.items():
        setattr(config.model, k, v)
    return config


def _assert_same(a, b, path="payload"):
    """Equal trees of tensors and plain values, tensors bit for bit."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path
    else:
        assert a == b, path


def _final(out: Path, steps: int):
    """The nerfacto run's checkpoint payload at ``steps``."""
    return ttrainer.read_checkpoint(out / "run" / "nerfacto" / "t" / "nerfstudio_models", steps)[1]


N = 4


def test_nerfacto_resume_is_bit_equal(scene, tmp_path):
    """2N steps straight against N, a checkpoint, a resume and N more: the
    model, every Adam moment and count, the occupancy grid, the step and the
    generator's state equal bit for bit."""
    straight = _config("nerfacto", scene, tmp_path / "straight", 2 * N, **TINY_RUN)
    straight.trainer.save_only_latest_checkpoint = False
    straight.trainer.steps_per_save = N
    build_trainer(straight).train()
    first = _config("nerfacto", scene, tmp_path / "first", N, **TINY_RUN)
    build_trainer(first).train()
    resumed = _config("nerfacto", scene, tmp_path / "resumed", 2 * N, **TINY_RUN)
    resumed.trainer.load_dir = tmp_path / "first" / "run" / "nerfacto" / "t" / "nerfstudio_models"
    trainer = build_trainer(resumed)
    assert trainer.state.step == N
    trainer.train()
    a, b = _final(tmp_path / "straight", 2 * N), _final(tmp_path / "resumed", 2 * N)
    assert a["step"] == 2 * N and a["optimizer"]["count"] == 2 * N
    assert not torch.equal(a["aux"]["densities"], torch.zeros_like(a["aux"]["densities"]))  # the hook ran
    _assert_same(a, b)
    # the straight run kept the step-N file too; it equals the first run's
    _assert_same(_final(tmp_path / "straight", N), _final(tmp_path / "first", N))
    assert ttrainer.checkpoint_steps(resumed.trainer.load_dir) == [N]  # only the latest


def test_splatfacto_resume_across_refines_is_bit_equal(scene, tmp_path):
    """The same for splatfacto with refines at steps 3 and 6 (warm-up 2,
    every 3; the second after the save at N = 4) and a random background
    each step: gaussians, Adam state, densification state, step, the
    generator's and the camera order's states. The first run stops at N
    inside a 2N-step config (the means schedule spans the config's steps)."""
    from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline

    kw = dict(warmup_length=2, refine_every=3, max_gaussians=600, num_random=200, random_init=True,
              sh_degree_interval=3)

    def config(name, load=None):
        c = _config("splatfacto", scene, tmp_path / name, 2 * N, **kw)
        c.dataparser.load_3D_points = False
        c.trainer.steps_per_save = N
        c.trainer.load_dir = load
        return c

    ckpt = lambda name: tmp_path / name / "run" / "splatfacto" / "t" / "nerfstudio_models"  # noqa: E731
    train_splat(config("straight"))
    pipeline, state = build_splat_pipeline(config("first"))
    pipeline.train(state, N, torch.Generator().manual_seed(42), ckpt_dir=ckpt("first"), steps_per_save=N)
    train_splat(config("resumed", load=ckpt("first")))
    a, b = (ttrainer.read_checkpoint(ckpt(name), 2 * N)[1] for name in ("straight", "resumed"))
    assert a["step"] == 2 * N and a["optimizer"]["count"] == 2 * N
    assert int(a["aux"]["alive"].sum()) != 200  # the refines changed the live set
    _assert_same(a, b)


class _Stub:
    """A pipeline, state and datamanager with only what the loops read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _record(trainer, events):
    """Record the loop's calls on ``trainer`` as (what, step)."""
    trainer.train_iteration = lambda step: {"loss": 0.0}
    trainer.eval_batch_iteration = lambda step: events.append(("eval_batch", step))
    trainer.eval_iteration = lambda step: events.append(("eval_image", step))
    trainer.save_checkpoint = lambda step: events.append(("save", step))
    trainer.pipeline.get_average_eval_image_metrics = lambda state: {}
    put = trainer.writer.put_dict
    trainer.writer.put_dict = lambda prefix, values, step: (
        events.append((prefix, step)) if prefix == "eval_all" else put(prefix, values, step))


def test_eval_and_save_cadence_matches_jax(tmp_path):
    """Both trainers' loops over 23 steps with saves every 5, eval batches
    every 3, eval images every 4 and all eval images every 7: the same
    calls at the same steps."""
    from nerfstudio_tpu.engine.trainer import Trainer as JTrainer
    from nerfstudio_tpu.engine.trainer import TrainerConfig as JTrainerConfig

    kw = dict(max_num_iterations=23, steps_per_save=5, steps_per_eval_batch=3, steps_per_eval_image=4,
              steps_per_eval_all_images=7, vis="none", timestamp="t")
    dm = _Stub(config=_Stub(train_num_rays_per_batch=8))
    got = {}
    for side, cfg_cls, make in (
        ("jax", JTrainerConfig, lambda cfg: JTrainer(cfg, _Stub(datamanager=dm))),
        ("torch", ttrainer.TrainerConfig,
         lambda cfg: ttrainer.Trainer(cfg, _Stub(datamanager=dm, device=torch.device(CPU)), None)),
    ):
        trainer = make(cfg_cls(output_dir=tmp_path / side, **kw))
        trainer.state = _Stub(step=0, params={})
        events = []
        _record(trainer, events)
        trainer.train()
        got[side] = events
    assert got["torch"] == got["jax"]
    assert ("save", 5) in got["jax"] and ("eval_all", 14) in got["jax"] and got["jax"][-1] == ("save", 23)


@pytest.fixture(scope="module")
def factory_pair(scene):
    """JAX's and the port's factory-built nerfacto pipelines on the scene,
    the tiny model, flat hash tables (as test_torch_train_step's main
    cases: K1 then returns the same value whichever corners it picks)."""
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
    host_state = jax.device_get(jstate.replace(params=params))  # each test starts from it (steps donate)
    config = _config("nerfacto", scene, Path("unused"), 1, **TINY_MODEL)
    pipe, state, config = build_pipeline(config)
    return jpipe, host_state, jconfig, pipe, state, config


def _jax_grads(jpipe, params, aux, key, kwargs, head_float32=False):
    """The gradients of JAX's train step at ``params`` (its loss_fn, as
    test_torch_train_step's world builds it); with ``head_float32`` the
    field's colour head computes in float32 instead of bfloat16 (the field
    builds its MLPs at each apply, from its module's ``MLP``)."""
    import nerfstudio_tpu.fields.nerfacto_field as jfield
    from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices

    dm, jmodel = jpipe.datamanager, jpipe.model_train
    k_pix, k_model = jax.random.split(key)
    idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

    def loss_fn(p):
        outputs = jmodel.apply(p, generate_rays_from_indices(dm.train_cameras, idx), key=k_model, model_aux=aux,
                               **kwargs)
        metrics = jmodel.get_metrics_dict(outputs, batch, p)
        return sum(jmodel.get_loss_dict(outputs, batch, metrics, p, config=jmodel.config).values())

    mlp = jfield.MLP
    if head_float32:
        jfield.MLP = functools.partial(mlp, dtype=jax.numpy.float32)
    try:
        return jax.device_get(jax.jit(jax.grad(loss_fn))(params))
    finally:
        jfield.MLP = mlp


def _prepared(factory_pair, step):
    """JAX's state (params, fresh optimizer, occupancy grid) converted by
    ``trainer_checkpoint_from_jax`` and restored into the port's pipeline,
    both at ``step`` after the occupancy hook with JAX's draws: (JAX's
    pipeline, its state, the port's pipeline, its state, the step's key and
    kwargs)."""
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto

    jpipe, host_state, jconfig, pipe, state, config = factory_pair
    payload = trainer_checkpoint_from_jax(host_state, pipe.model, state.optimizer)
    ttrainer.restore_train_state(pipe, state, payload)
    assert state.step == 0 and state.optimizer.count == 0
    jstate = jax.tree_util.tree_map(jax.numpy.asarray, host_state).replace(step=jax.numpy.asarray(step, jax.numpy.int32))
    state.step = step
    k_aux, k_step = jax.random.split(jax.random.PRNGKey(7))
    jstate = jpipe.aux_update_fn(jstate, step, k_aux)
    cells, jitter = jax_occupancy_draws(k_aux, jconfig.model.occ_grid_resolution, jconfig.model.occ_cells_per_update)
    pipe.aux_update_fn(state, step, cells=cells, jitter=jitter)
    np.testing.assert_allclose(state.aux.densities.numpy(), np.asarray(jstate.aux.densities), rtol=1e-4, atol=1e-6)
    assert (state.aux.binary.numpy() == np.asarray(jstate.aux.binary)).mean() >= 0.999
    kwargs = JNerfacto.step_kwargs(step, jconfig.model)
    assert type(pipe.model).step_kwargs(step, config.model) == kwargs
    return jpipe, jstate, pipe, state, k_step, kwargs


@pytest.mark.parametrize("step", [304, 6000], ids=["early", "steady"])
def test_factory_built_step_matches_jax(factory_pair, step):
    """The occupancy hook and one step with JAX's draws (``_prepared``), at
    test_torch_train_step's tolerances: the grid's densities to 1e-4 and
    binary cells on >= 99.9%; the loss and its terms to 2e-3; each
    non-table gradient within 5e-2 of its largest entry, each table's
    gradient summed per level and feature within 1e-3 of the largest such
    sum. The colour head's biases are held to JAX's gradient with that head
    in float32: on this scene (a sphere on white) JAX's bfloat16 sum of the
    bias cotangent lies further from its own float32 value than the port's
    does (asserted over the head's biases, each relative to its peak), and
    test_colour_head_in_float32_matches_jax shows the two heads equal in
    float32. The live proposal table's per-level sums are held to 1e-2
    (3.8e-3 measured: with flat tables the interlevel term that drives it is
    ~1e-6)."""
    jpipe, jstate, pipe, state, k_step, kwargs = _prepared(factory_pair, step)
    model, config = pipe.model, factory_pair[-1]
    jgrads = params_from_jax(_jax_grads(jpipe, jstate.params, jstate.aux, k_step, kwargs), model)
    jgrads32 = params_from_jax(_jax_grads(jpipe, jstate.params, jstate.aux, k_step, kwargs, head_float32=True), model)
    jstate, jmetrics = jpipe.train_step(jstate, jpipe.datamanager.train_images, k_step, **kwargs)
    tmetrics = pipe.train_step(state, draws=jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW), **kwargs)
    for k in ("loss", "rgb_loss", "distortion_loss", "interlevel_loss", "psnr"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=2e-3, atol=1e-7, err_msg=k)
    off_float32 = {"port": 0.0, "jax": 0.0}
    for n, p in model.named_parameters():
        head_bias = n.startswith("field.mlp_head") and n.endswith("bias")
        ref = (jgrads32 if head_bias else jgrads)[n].numpy().astype(np.float64)
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy().astype(np.float64)
        if head_bias:
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


def _float32_forward(self, x):
    """The port's MLP forward with every product and sum in float32."""
    h = x.float()
    for i, layer in enumerate(self.layers):
        h = torch.nn.functional.linear(h, layer.weight) + layer.bias
        if i < len(self.layers) - 1:
            h = self.act(h)
    return self.out_act(h)


def test_colour_head_in_float32_matches_jax(factory_pair, monkeypatch):
    """With the field's colour head in float32 on both sides, one step with
    JAX's draws gives every gradient of the head within 1e-3 of its peak:
    the colour path (background, alpha, the head) is the same, and the
    bfloat16 heads differ only in how each rounds."""
    jpipe, jstate, pipe, state, k_step, kwargs = _prepared(factory_pair, 304)
    head = pipe.model.field.mlp_head
    monkeypatch.setattr(head, "forward", types.MethodType(_float32_forward, head))
    jgrads = params_from_jax(_jax_grads(jpipe, jstate.params, jstate.aux, k_step, kwargs, head_float32=True),
                             pipe.model)
    pipe.train_step(state, draws=jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW), **kwargs)
    for n, p in pipe.model.named_parameters():
        if n.startswith("field.mlp_head"):
            ref = jgrads[n].numpy().astype(np.float64)
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max(), err_msg=n)


def test_jax_splat_state_resumes_in_the_port(scene, tmp_path):
    """A JAX ``SplatTrainState`` as the port's checkpoint: the gaussians,
    the densification state and every array's moments and count land in a
    factory-built splat pipeline, which trains on from there."""
    from nerfstudio_tpu.models.splatfacto import SplatAux as JSplatAux
    from nerfstudio_tpu.pipelines.splat_pipeline import SplatTrainState, build_splat_optimizers
    from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline

    config = _config("splatfacto", scene, tmp_path, 3, max_gaussians=64, num_random=32, random_init=True)
    config.dataparser.load_3D_points = False
    pipe, state = build_splat_pipeline(config)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in state.params.items()}
    tx = build_splat_optimizers(config.model, max_steps=3)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    _, opt_state = tx.update(grads, tx.init(params), params)
    aux = JSplatAux(alive=np.arange(64) < 40, grad_accum=rng.uniform(size=64).astype(np.float32),
                    grad_count=np.full(64, 2.0, np.float32), max_radii=np.zeros(64, np.float32))
    jstate = jax.device_get(SplatTrainState(params=params, opt_state=opt_state, aux=aux, step=np.int32(1)))
    ckpt = tmp_path / "ckpt"
    ttrainer.write_checkpoint(ckpt, 1, trainer_checkpoint_from_jax(jstate, max_steps=3))
    pipe.load_checkpoint(state, ckpt)
    assert state.step == 1 and state.optimizer.count == 1 and int(state.aux.alive.sum()) == 40
    for k, v in params.items():
        np.testing.assert_array_equal(state.params[k].detach().numpy(), v)
        adam = opt_state.inner_states[k].inner_state[0]
        st = state.optimizer.optimizer.state[state.params[k]]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(adam.mu[k]))
    state, metrics = pipe.train(state, 3, torch.Generator().manual_seed(0))
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
