"""Splatfacto on the port's data-parallel layer on the CPU, with 2 gloo
ranks in processes of their own (``_torch_ddp.run_ranks``): one step at 2
ranks (one camera each) against JAX's ``SplatPipeline(...,
mesh=make_mesh(jax.devices()[:2])).build_train_step_batch()`` at B=2 with
its backgrounds and noise handed in, with camera optimisation and the
bilateral grid and with MCMC; the replicas bit-equal after steps across
refines; mixed resolutions refused; the training CLI on 2 ranks (rank 0
alone writes, a resume bit-equal to a continued run); generfacto refused
on 2 devices."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)
import _torch_ddp as ddp
from _torch_port import NUM_IMAGES
from fixtures import make_mixed_res_fixture, make_nerfstudio_fixture
from test_torch_splatfacto import SLOTS, TINY, H, K, W, _c2w, _jax_state_arrays, _t
from test_torch_splatfacto_mcmc import MEANS_LR, OPTIONS, _JaxDM
from test_torch_trainer import _assert_same, _config
from nerfstudio_tpu.models.splatfacto import SplatfactoModel as JModel
from nerfstudio_tpu.models.splatfacto import SplatfactoModelConfig as JConfig
from nerfstudio_tpu.parallel.mesh import data_sharding, make_mesh, replicated
from nerfstudio_tpu.pipelines.splat_pipeline import SplatPipeline as JPipeline
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig
from nerfstudio_torch.utils.convert import splat_state_from_jax

HW = 16
# each step's two cameras: (c2w angle, camera index) per rank
CAMERAS = (((0.3, 1), (1.1, 3)), ((0.9, 2), (1.7, 0)))


def _jax_batch_steps(option):
    """Two steps of JAX's mesh step at B=2 on 2 devices from a structured
    init (the first so the moments and per-image arrays are not at their
    init): (the state before the second as numpy, its metrics, the state
    after, its two backgrounds, its noise, its two ground truths)."""
    params, _ = _jax_state_arrays(6)
    mesh = make_mesh(jax.devices()[:2])
    pipe = JPipeline(_JaxDM(), JModel(JConfig(**TINY, **OPTIONS[option]), scene_scale=1.5), max_steps=30000,
                     mesh=mesh)
    state = pipe.init_state(scene_scale=1.5, seed=6, n_cap_override=SLOTS)
    params = {**state.params, **params}
    state = jax.device_put(state.replace(params=params, opt_state=pipe.tx.init(params)), replicated(mesh))
    step = pipe.build_train_step_batch()
    shard = data_sharding(mesh)
    rng = np.random.default_rng(7)
    gts = rng.uniform(size=(2, 2, H, W, 3)).astype(np.float32)
    Ks = np.array([K, K], np.float32)
    for i, cams in enumerate(CAMERAS):
        keys = jax.random.split(jax.random.PRNGKey(i), 2)
        if i == 1:
            before = jax.device_get(state)
        args = (np.stack([_c2w(a) for a, _ in cams]), Ks, gts[i], keys, np.array([c for _, c in cams], np.int32))
        state, metrics = step(state, *(jax.device_put(jnp.asarray(x), shard) for x in args), width=W, height=H,
                              sh_degree=3, means_lr=MEANS_LR)
    bgs = [np.asarray(jax.random.uniform(jax.random.split(k)[0], (3,))) for k in keys]
    noise = np.asarray(jax.random.normal(jax.random.fold_in(keys[0], 1), (SLOTS, 3)))
    return before, {k: float(v) for k, v in metrics.items()}, jax.device_get(state), bgs, noise, gts[1]


@pytest.mark.parametrize("option", ["all", "mcmc"], ids=["camera_opt_bilateral", "mcmc"])
def test_two_rank_step_matches_jax_batch_step(option, tmp_path):
    """One step from JAX's state on 2 ranks, rank r on camera r with JAX's
    background r and the shared noise, against JAX's B=2 step: ``all`` is
    SO3xR3 camera optimisation, the bilateral grid and scale
    regularisation, each rank indexing its own camera's tangent and grid.
    K6's twin blends each pixel to the end of its list, as the reference
    does (``TRANSMITTANCE_EPS`` 0): with gsplat's stop at 1e-4 a gaussian
    seen only behind it gets another gradient (here up to 6.4e-3 of the
    array's peak, 2.3e-3 on one camera alone; test_torch_splatfacto's
    single-camera steps hold the stop), which would hide what this test
    holds: the all-reduced mean over the ranks' cameras and each view's
    statistics at the one-camera scale, summed. Ceilings, the measured gaps
    in brackets: the mean loss within 1e-5 relative (5.1e-7), the other
    metrics 1e-5 (1.0e-6); each array's all-reduced gradient (JAX's
    recovered from its first moments) within 1e-4 of its peak (1.2e-5),
    the camera-opt tangents' and the grids' included; the arrays after
    Adam within 1e-3 of the largest update where the gradient is at least
    1e-2 of its peak (2.4e-4); moments within 1e-4 of their peak (1.5e-5);
    ``grad_count`` and ``max_radii`` equal, ``grad_accum`` within 1e-4 of
    its peak (1.5e-6). The two ranks' arrays, moments and statistics
    bit-equal."""
    before, jm, after, bgs, noise, gts = _jax_batch_steps(option)
    params, aux, moments, step = splat_state_from_jax(before)
    cfg = SplatfactoModelConfig(**TINY, **OPTIONS[option])
    cams = [(_t(_c2w(a)), tuple(float(k) for k in K), _t(gts[r]), _t(bgs[r]), c)
            for r, (a, c) in enumerate(CAMERAS[1])]
    a, b = ddp.run_ranks(ddp.splat_step, (cfg, (params, aux, moments, step), cams, _t(noise), MEANS_LR, 0.0), 2,
                         tmp_path)
    for key in ("params", "moments", "aux"):
        _assert_same(a[key], b[key], key)
    assert abs(a["metrics"]["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
    for k in ("l1", "ssim_loss", "psnr", "num_alive"):
        assert math.isclose(a["metrics"][k], jm[k], rel_tol=1e-5), k
    assert a["step"] == int(after.step) == 2
    _, _, jmom, _ = splat_state_from_jax(after)
    assert set(a["params"]) == set(after.params)
    for k, v in after.params.items():
        g_jax = ((jmom[k][1] - 0.9 * moments[k][1]) / 0.1).numpy()
        peak = np.abs(g_jax).max()
        assert peak > 0, k
        value, grad = a["params"][k]
        assert np.abs(grad.numpy() - g_jax).max() <= 1e-4 * peak, k
        new, old = np.asarray(v), params[k].numpy()
        strong = np.abs(g_jax) >= 1e-2 * peak
        assert np.abs(value.numpy() - new)[strong].max() <= 1e-3 * np.abs(new - old).max(), k
    for k, (count, mu, nu) in jmom.items():
        s = a["moments"][k]
        assert int(s["step"]) == count == 2
        for got, want in ((s["exp_avg"], mu), (s["exp_avg_sq"], nu)):
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), k
    np.testing.assert_array_equal(a["aux"]["grad_count"].numpy(), np.asarray(after.aux.grad_count))
    assert float(a["aux"]["grad_count"].max()) == 4.0  # two steps of two views
    np.testing.assert_array_equal(a["aux"]["max_radii"].numpy(), np.asarray(after.aux.max_radii))
    ga = np.asarray(after.aux.grad_accum)
    assert np.abs(a["aux"]["grad_accum"].numpy() - ga).max() <= 1e-4 * ga.max()


# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_nerfstudio_fixture(tmp_path_factory.mktemp("scene") / "ns", n=NUM_IMAGES + 1, hw=HW)


KW = dict(warmup_length=2, refine_every=3, max_gaussians=600, num_random=200, random_init=True, sh_degree_interval=3)


def _splat_config(scene, out, steps, **model):
    c = _config("splatfacto", scene, out, steps, **{**KW, **model})
    c.dataparser.load_3D_points = False
    return c


@pytest.mark.parametrize("strategy", ["default", "mcmc"])
def test_replicas_stay_bit_equal_across_refines(scene, tmp_path, strategy):
    """``SplatPipeline.train`` on 2 ranks for 8 steps with refines at 3
    and 6 (the default strategy's split, or MCMC's relocation with its
    noise) and a random background each step: the gaussians, every Adam
    moment and count, the densification statistics, the step and the
    generator's state equal bit for bit on both ranks, and the refines
    changed the live set."""
    config = _splat_config(scene, tmp_path, 8, strategy=strategy)
    a, b = ddp.run_ranks(ddp.splat_train, (config, 8), 2, tmp_path)
    _assert_same(a["state"], b["state"])
    assert a["state"]["step"] == 8 and a["state"]["optimizer"]["count"] == 8
    assert float(a["state"]["aux"]["grad_count"].sum()) > 0
    if strategy == "default":
        assert int(a["state"]["aux"]["alive"].sum()) != 200
    assert np.isfinite(a["metrics"]["loss"]) and a["metrics"] == b["metrics"]


def test_mixed_resolutions_are_refused_on_two_ranks(tmp_path):
    """One camera per rank and one (H, W) a step: a capture of two
    resolutions raises on 2 ranks (reference splat_pipeline.py:549-552),
    in the datamanager, which holds one (N, H, W, C) stack."""
    mixed = make_mixed_res_fixture(tmp_path / "mixed", n=NUM_IMAGES + 1, hws=(HW, 12))
    with pytest.raises(Exception, match="variable resolutions"):
        ddp.run_ranks(ddp.splat_train, (_splat_config(mixed, tmp_path, 2), 2), 2, tmp_path)


def _cli(scene, out, steps, extra=()):
    return ["splatfacto", "--data", str(scene), "--machine.device-type", "cpu", "--machine.num-devices", "2",
            "--trainer.output-dir", str(out), "--trainer.experiment-name", "run", "--trainer.timestamp", "t",
            "--trainer.vis", "none", "--trainer.max-num-iterations", str(steps),
            "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", str(NUM_IMAGES + 1),
            "--dataparser.load-3D-points", "False",
            *[x for k, v in KW.items() for x in (f"--model.{k}", str(v))], *extra]


def test_cli_two_ranks_resume_is_bit_equal(scene, tmp_path):
    """``scripts.train splatfacto --machine.device-type cpu
    --machine.num-devices 2`` for 8 steps with a save at 4, then a resume
    from that save to 8: the two step-8 checkpoints equal bit for bit
    (gaussians, Adam state, statistics, the generator's and the camera
    order's states); rank 0 alone wrote the config and the checkpoints."""
    from nerfstudio_torch.scripts import train

    ckpt = lambda name: tmp_path / name / "run" / "splatfacto" / "t" / "nerfstudio_models"  # noqa: E731
    train.main(_cli(scene, tmp_path / "straight", 8, ["--trainer.steps-per-save", "4",
                                                     "--trainer.save-only-latest-checkpoint", "False"]))
    train.main(_cli(scene, tmp_path / "resumed", 8, ["--trainer.load-dir", str(ckpt("straight")),
                                                    "--trainer.load-step", "4"]))
    a, b = (ttrainer.read_checkpoint(ckpt(name), 8)[1] for name in ("straight", "resumed"))
    assert a["step"] == 8 and a["optimizer"]["count"] == 8
    _assert_same(a, b)
    run = ckpt("straight").parent
    assert sorted(p.name for p in run.iterdir()) == ["config.pkl", "config.yml", "nerfstudio_models", "scalars.jsonl"]
    assert ttrainer.checkpoint_steps(ckpt("straight")) == [4, 8]
    assert len((run / "scalars.jsonl").read_text().splitlines()) == 1  # step 0's, written once, by rank 0


def test_generfacto_refuses_two_devices(tmp_path):
    from nerfstudio_torch.scripts import train

    with pytest.raises(ValueError, match="generfacto trains on one device"):
        train.main(["generfacto", "--machine.device-type", "cpu", "--machine.num-devices", "2",
                    "--trainer.output-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
