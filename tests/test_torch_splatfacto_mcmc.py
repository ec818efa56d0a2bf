"""splatfacto's MCMC strategy, bilateral grid, camera optimisation and
scale regularisation in the port against the JAX package on the CPU (64x48,
512 slots, 64 refine slots, four training images): MCMC's relocation,
refine slot for slot (with JAX's categorical draws, and with a source drawn
on both sides of the written slots' end), its position noise, the loss
terms, one train step per option against JAX's from ``splat_state_from_jax``,
MCMC's refine schedule against JAX's ``train``, the eval's colour
correction, and a checkpoint round trip with the per-image arrays.

Random draws (categorical sources, noise, backgrounds) are JAX's, handed to
the port. Tolerances are stated per test."""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU
from nerfstudio_tpu.model_components import bilateral_grid as jbg
from nerfstudio_tpu.models.splatfacto import SplatfactoModel as JModel
from nerfstudio_tpu.models.splatfacto import SplatfactoModelConfig as JConfig
from nerfstudio_tpu.pipelines.splat_pipeline import SplatPipeline as JPipeline
from nerfstudio_tpu.pipelines.splat_pipeline import build_splat_optimizers
from nerfstudio_tpu.utils import metrics as jmetrics
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.datamanagers import FullImageDatamanager
from nerfstudio_torch.models.splatfacto import SplatAux, SplatfactoModel, SplatfactoModelConfig
from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline
from nerfstudio_torch.utils.convert import splat_state_from_jax
from test_torch_splatfacto import SLOTS, TINY, H, K, W, _c2w, _jax_state_arrays, _t, jax_init_draws

N_IMAGES = 4
MEANS_LR = 1.6e-4
OPTIONS = {
    "mcmc": dict(strategy="mcmc"),
    "bilateral": dict(use_bilateral_grid=True),
    "camera_opt": dict(camera_optimizer_mode="SO3xR3"),
    "camera_opt_se3": dict(camera_optimizer_mode="SE3"),
    "scale_reg": dict(use_scale_regularization=True),
    "all": dict(use_bilateral_grid=True, camera_optimizer_mode="SO3xR3", use_scale_regularization=True),
}


class _JaxDM:
    """What the JAX pipeline's init reads of a datamanager: the image count."""

    class train_dataset:
        def __len__(self):
            return N_IMAGES

    train_dataset = train_dataset()


def _mcmc_state(seed):
    """JAX params with some dead gaussians (opacity below mcmc_min_opacity),
    an Adam state with moments at count 5, and aux."""
    params, aux = _jax_state_arrays(seed)
    rng = np.random.default_rng(seed + 20)
    alive = np.asarray(aux.alive)
    op = np.array(params["opacities"])
    dead = rng.choice(np.nonzero(alive)[0], 20, replace=False)
    op[dead] = rng.uniform(-9.0, -5.4, (20, 1)).astype(np.float32)  # sigmoid < 0.0045
    params = dict(params, opacities=jnp.asarray(op))
    tx = build_splat_optimizers(JConfig(**TINY, strategy="mcmc"), max_steps=100)
    leaves, treedef = jax.tree_util.tree_flatten(tx.init(params))
    leaves = [jnp.full(x.shape, 5, x.dtype) if x.ndim == 0 else
              jnp.asarray(rng.uniform(0.1, 1.0, x.shape).astype(np.float32)) for x in leaves]
    return params, jax.tree_util.tree_unflatten(treedef, leaves), aux


def _port_state(params, opt_state, aux, cfg):
    state = dict(params=params, opt_state=opt_state, aux=aux, step=np.int32(0))
    tparams, taux, moments, _ = splat_state_from_jax(jax.device_get(state))
    pipeline = SplatPipeline(None, SplatfactoModel(cfg, scene_scale=1.5), max_steps=100)
    return pipeline, pipeline.state_from(tparams, taux, moments)


def test_relocation_matches_jax():
    """New opacities within 1e-7 and log scales within 2e-6 for every
    ratio 1..51 (the binomial table's float32 sums, in another order)."""
    rng = np.random.default_rng(0)
    o = rng.uniform(0.001, 0.999, 2000).astype(np.float32)
    o[:5] = [0.999, 0.9999, 0.5, 1e-6, 0.01]
    s = rng.normal(size=(2000, 3)).astype(np.float32)
    r = rng.integers(1, 52, 2000).astype(np.int32)
    r[:51] = np.arange(1, 52)
    r[51:53] = [0, 70]  # clipped to [1, 51]
    jo, js = JModel._relocation(jnp.asarray(o), jnp.asarray(s), jnp.asarray(r))
    to, ts = SplatfactoModel._relocation(_t(o), _t(s), _t(r))
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1e-7
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 2e-6
    assert np.isfinite(ts.numpy()).all()


def _check_refine(jp, jo, ja, pipeline, st, state):
    """Port state after refine_mcmc equals JAX's: alive, every slot within
    1e-6 (the relocation), moments zeroed on the same rows."""
    np.testing.assert_array_equal(st.aux.alive.numpy(), np.asarray(ja.alive))
    for k, v in jp.items():
        np.testing.assert_allclose(st.params[k].detach().numpy(), np.asarray(v), atol=2e-6, err_msg=k)
    _, _, jmom, _ = splat_state_from_jax(jax.device_get(dict(state, opt_state=jo)))
    for k, (count, mu, nu) in jmom.items():
        s = st.optimizer.optimizer.state[st.params[k]]
        assert int(s["step"]) == count == 5
        np.testing.assert_array_equal(s["exp_avg"].numpy(), mu.numpy(), err_msg=k)
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), nu.numpy(), err_msg=k)
    for k in ("grad_accum", "grad_count", "max_radii"):
        assert not getattr(st.aux, k).any()


def test_refine_mcmc_matches_jax_slot_for_slot():
    """One MCMC refine with JAX's own categorical draw handed in: 20 dead
    slots and 14 of growth (5% of the 280 live) rewritten, the copies'
    sources relocated."""
    params, opt_state, aux = _mcmc_state(3)
    cfg = JConfig(**TINY, strategy="mcmc")
    key = jax.random.PRNGKey(11)
    jp, jo, ja = JModel(cfg, scene_scale=1.5).refine_mcmc(params, opt_state, aux, key)
    pipeline, st = _port_state(params, opt_state, aux, SplatfactoModelConfig(**TINY, strategy="mcmc"))
    opac = jax.nn.sigmoid(params["opacities"][:, 0])
    live = aux.alive & ~(opac < cfg.mcmc_min_opacity)
    logits = jnp.where(live, jnp.log(jnp.maximum(opac, 1e-8)), -1e9)
    src = jax.random.categorical(jax.random.split(key)[0], logits, shape=(64,))
    # the port's source weights are the same distribution
    probs = pipeline.model.mcmc_src_probs(st.params, st.aux).numpy()
    np.testing.assert_allclose(probs / probs.sum(), np.asarray(jax.nn.softmax(logits)), rtol=1e-5, atol=1e-12)
    pipeline.refine_mcmc(st, _t(src))
    written = np.asarray(ja.alive) & ~np.asarray(aux.alive)
    assert written.sum() == 14 and len(np.unique(np.asarray(src))) < 64
    _check_refine(jp, jo, ja, pipeline, st, dict(params=params, opt_state=opt_state, aux=aux, step=np.int32(0)))


def test_refine_mcmc_duplicate_sources_keep_the_last_draw(monkeypatch):
    """Sources drawn more than once, handed to both sides: one drawn at
    ranks 5 and 20 (both written), one at ranks 10 and 50 and one at 30 and
    40 (the second draw of each past the 34 written slots). XLA's scatter
    keeps the last draw's update, so the last two sources keep their old
    scale and opacity and their moments though they were copied; the port
    resolves it the same way. Exact on alive and the moments, 1e-6 on the
    values."""
    params, opt_state, aux = _mcmc_state(4)
    alive = np.asarray(aux.alive)
    op = 1 / (1 + np.exp(-np.asarray(params["opacities"])[:, 0]))
    live = np.nonzero(alive & (op >= 0.005))[0]
    rng = np.random.default_rng(5)
    src = rng.choice(live, 64).astype(np.int32)
    a, b, c = rng.choice(np.setdiff1d(live, src), 3, replace=False)
    src[[5, 20]], src[[10, 50]], src[[30, 40]] = a, b, c
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, shape: jnp.asarray(src))
    cfg = JConfig(**TINY, strategy="mcmc")
    jp, jo, ja = JModel(cfg, scene_scale=1.5).refine_mcmc(params, opt_state, aux, jax.random.PRNGKey(0))
    n_written = int((np.asarray(ja.alive) & ~alive).sum()) + 20
    assert n_written == 34
    pipeline, st = _port_state(params, opt_state, aux, SplatfactoModelConfig(**TINY, strategy="mcmc"))
    pipeline.refine_mcmc(st, _t(src))
    _check_refine(jp, jo, ja, pipeline, st, dict(params=params, opt_state=opt_state, aux=aux, step=np.int32(0)))
    old_scales = np.asarray(params["scales"])
    assert (np.asarray(jp["scales"])[a] != old_scales[a]).all()
    for kept in (b, c):
        np.testing.assert_array_equal(np.asarray(jp["scales"])[kept], old_scales[kept])
        np.testing.assert_array_equal(st.params["scales"][kept].detach().numpy(), old_scales[kept])


def test_mcmc_noise_matches_jax():
    """The means after the position noise, with JAX's normal draw: within
    1e-6 of the largest move (two 3x3 products summed in another order)."""
    params, aux = _jax_state_arrays(8)
    cfg = JConfig(**TINY, strategy="mcmc")
    key = jax.random.PRNGKey(3)
    want = np.asarray(JModel(cfg).mcmc_noise(params, aux.alive, key, MEANS_LR))
    eps = _t(jax.random.normal(key, (SLOTS, 3)))
    tparams = {k: _t(v) for k, v in params.items()}
    got = SplatfactoModel(SplatfactoModelConfig(**TINY, strategy="mcmc")).mcmc_noise(
        tparams, _t(aux.alive), eps, MEANS_LR).numpy()
    move = np.abs(want - np.asarray(params["means"])).max()
    assert move > 0
    assert np.abs(got - want).max() <= 1e-6 * move + 1e-7


@pytest.mark.parametrize("option", ["mcmc", "all"])
def test_loss_terms_match_jax(option):
    """Every term of get_loss over a fixed render and the params, and the
    gradient of the total into each array: within 1e-5 relative (sums over
    512 slots in another order; SSIM as in the splatfacto test), the TV
    term within 3e-5 (JAX's float32 mean over the 4 grids' ~10^5
    differences is itself ~1.4e-5 off its float64 value)."""
    params, aux = _jax_state_arrays(9)
    rng = np.random.default_rng(10)
    grids = np.asarray(jbg.init_bilateral_grid(N_IMAGES)) + rng.normal(0, 0.05, (N_IMAGES, 12, 8, 16, 16))
    params = dict(params, bilateral_grids=jnp.asarray(grids.astype(np.float32)))
    scales = np.array(params["scales"])
    scales[:40, 0] += 3.0  # ratios above max_gauss_ratio
    params["scales"] = jnp.asarray(scales)
    pred = rng.uniform(size=(H, W, 3)).astype(np.float32)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cfg = dict(TINY, **OPTIONS[option])

    def jloss(p):
        loss, d = JModel(JConfig(**cfg)).get_loss({"rgb": jnp.asarray(pred), "background": jnp.zeros(3)},
                                                  jnp.asarray(gt), p, aux.alive)
        return loss, d

    (jl, jd), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tl, td = SplatfactoModel(SplatfactoModelConfig(**cfg)).get_loss(
        {"rgb": _t(pred), "background": torch.zeros(3)}, _t(gt), tp, _t(aux.alive))
    tl.backward()
    terms = {"mcmc": ("mcmc_opacity_reg", "mcmc_scale_reg"), "all": ("scale_reg", "tv_loss")}[option]
    for k in ("main_loss", "loss") + terms:
        assert math.isclose(float(td[k].detach()), float(jd[k]), rel_tol=3e-5 if k == "tv_loss" else 1e-5), k
    assert float(td[terms[0]].detach()) > 0
    for k in ("scales", "opacities", "bilateral_grids"):
        want = np.asarray(jg[k])
        if not np.abs(want).max():
            assert tp[k].grad is None or not tp[k].grad.any(), k
            continue
        assert np.abs(tp[k].grad.numpy() - want).max() <= 1e-5 * np.abs(want).max(), k


def _jax_two_steps(option):
    """Two JAX train steps of the option's config (the first so moments and
    the per-image arrays are not at their init), camera 1 then camera 2:
    (state before the second step, its metrics, the state after, its
    background, noise and ground truth)."""
    params, _ = _jax_state_arrays(6)
    jcfg = JConfig(**TINY, **OPTIONS[option])
    pipe = JPipeline(_JaxDM(), JModel(jcfg, scene_scale=1.5), max_steps=30000)
    state = pipe.init_state(scene_scale=1.5, seed=6, n_cap_override=SLOTS)
    params = {**state.params, **params}
    state = state.replace(params=params, opt_state=pipe.tx.init(params))
    step = pipe.build_train_step()
    rng = np.random.default_rng(7)
    gts = [rng.uniform(size=(H, W, 3)).astype(np.float32) for _ in range(2)]
    kw = dict(width=W, height=H, sh_degree=3, means_lr=MEANS_LR)
    state, _ = step(state, _c2w(0.3), np.array(K, np.float32), jnp.asarray(gts[0]), jax.random.PRNGKey(0),
                    cam_idx=1, **kw)
    before = jax.device_get(state)
    key = jax.random.PRNGKey(1)
    after, metrics = step(state, _c2w(0.9), np.array(K, np.float32), jnp.asarray(gts[1]), key, cam_idx=2, **kw)
    k_bg, k_noise = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(k_bg, (3,)))
    noise = np.asarray(jax.random.normal(k_noise, (SLOTS, 3)))
    return before, {k: float(v) for k, v in metrics.items()}, jax.device_get(after), bg, noise, gts[1]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_with_each_option_matches_jax(option):
    """One step of the option's config from JAX's state, with JAX's
    background and noise, camera 2: as ``test_train_step_matches_jax``
    holds the plain step (K6's cutoff against the reference's chunk end),
    the loss within 1e-5 relative, each array's gradient (JAX's recovered
    from its first moments) within 1e-3 of its peak (camera_opt's and the
    bilateral grids' too), updates within 1e-2 of the largest where the
    gradient is at least 1e-2 of its peak, moments within 1e-3 of their
    peak, the densification stats as there. Under MCMC the means' update
    includes the noise."""
    before, jm, after, bg, noise, gt = _jax_two_steps(option)
    params, aux, moments, step = splat_state_from_jax(before)
    cfg = SplatfactoModelConfig(**TINY, **OPTIONS[option])
    pipeline = SplatPipeline(None, SplatfactoModel(cfg, scene_scale=1.5))
    st = pipeline.state_from(params, aux, moments, step)
    assert set(st.params) == set(after.params)
    metrics = pipeline.train_step(st, _t(_c2w(0.9)), tuple(float(k) for k in K), _t(gt), _t(bg), W, H, 3,
                                  cam_idx=2, noise=_t(noise), means_lr=MEANS_LR)
    assert abs(float(metrics["loss"]) - jm["loss"]) <= 1e-5 * abs(jm["loss"])
    for k in ("l1", "ssim_loss", "psnr", "num_alive"):
        assert math.isclose(float(metrics[k]), jm[k], rel_tol=1e-4), k
    _, _, jmom, _ = splat_state_from_jax(after)
    for k, v in after.params.items():
        g_jax = ((jmom[k][1] - 0.9 * moments[k][1]) / 0.1).numpy()
        peak = np.abs(g_jax).max()
        assert peak > 0, k
        assert np.abs(st.params[k].grad.numpy() - g_jax).max() <= 1e-3 * peak, k
        new, old = np.asarray(v), params[k].numpy()
        strong = np.abs(g_jax) >= 1e-2 * peak
        got = st.params[k].detach().numpy()
        assert np.abs(got - new)[strong].max() <= 1e-2 * np.abs(new - old).max(), k
    for k, (count, mu, nu) in jmom.items():
        s = st.optimizer.optimizer.state[st.params[k]]
        assert int(s["step"]) == count == 2
        for got, want in ((s["exp_avg"], mu), (s["exp_avg_sq"], nu)):
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), k
    np.testing.assert_array_equal(st.aux.grad_count.numpy(), np.asarray(after.aux.grad_count))
    np.testing.assert_array_equal(st.aux.max_radii.numpy(), np.asarray(after.aux.max_radii))


def test_mcmc_refine_schedule_follows_jax_train():
    """SplatPipeline.train refines by MCMC after the step wherever JAX's
    train calls its refine (step > warmup, every refine_every, below
    stop_split_at), with the sources drawn then; the two loops stubbed
    alike."""
    cfg = dict(TINY, strategy="mcmc", stop_split_at=1500)
    steps = (0, 500, 501, 600, 1400, 1499, 1500, 1600, 3000)
    jpipe = JPipeline(_JaxDM(), JModel(JConfig(**cfg)))
    cams = types.SimpleNamespace(**{k: np.full((2, 1), 8.0, np.float32) for k in ("fx", "fy", "cx", "cy")},
                                 height=np.full((2, 1), 8), width=np.full((2, 1), 8),
                                 camera_to_worlds=np.stack([_c2w(0.0), _c2w(1.0)]))
    jpipe.datamanager = types.SimpleNamespace(train_cameras=cams, next_train=lambda s: (0, np.zeros((8, 8, 3))))
    jcalls = []
    jpipe._train_step = lambda state, *a, **kw: (types.SimpleNamespace(step=state.step + 1, params=state.params), {})
    jpipe._refine = lambda state, key: jcalls.append(int(state.step) - 1) or state
    for s in steps:
        jpipe.train(types.SimpleNamespace(step=s, params={"means": np.zeros((SLOTS, 3))}), s + 1,
                    jax.random.PRNGKey(0))

    tcams = Cameras.create(np.stack([_c2w(0.0), _c2w(1.0)]), 8.0, 8.0, 4.0, 4.0, 8, 8, device=CPU)
    pipeline = SplatPipeline(FullImageDatamanager(tcams, torch.zeros((2, 8, 8, 3)), device=CPU),
                             SplatfactoModel(SplatfactoModelConfig(**cfg)))
    st = pipeline.init_state(scene_scale=1.5, draws=jax_init_draws(0, 300), device=CPU)
    calls = []
    pipeline.train_step = lambda state, *a, **kw: setattr(state, "step", state.step + 1) or {}
    pipeline.refine_mcmc = lambda state, src: calls.append((state.step - 1, tuple(src.shape)))
    pipeline.refine = lambda *a, **kw: pytest.fail("the default refine under mcmc")
    gen = torch.Generator().manual_seed(0)
    for s in steps:
        st.step = s
        pipeline.train(st, s + 1, gen)
    assert [s for s, _ in calls] == jcalls == [600, 1400]
    assert all(shape == (64,) for _, shape in calls)


def test_eval_metrics_color_correct_as_jax():
    """With the bilateral grid on, the eval's PSNR and SSIM are those of the
    render colour-corrected to the ground truth: against the JAX model's
    render put through JAX's color_correct, PSNR within 2e-3 dB and SSIM
    within 2e-4 (renders within 2e-4, as in the splatfacto eval test, then
    the float32 ridge fit)."""
    params, aux = _jax_state_arrays(11)
    rng = np.random.default_rng(12)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    jout = JModel(JConfig(**TINY), scene_scale=1.5).render(params, aux.alive, jnp.asarray(_c2w(0.9)), K, W, H,
                                                          sh_degree_active=3, background=jnp.zeros(3))
    jpred = jbg.color_correct(jout["rgb"], jnp.asarray(gt))
    cams = Cameras.create(_c2w(0.9)[None], *K, W, H, device=CPU)
    dm = FullImageDatamanager(cams, _t(gt)[None], device=CPU)
    cfg = SplatfactoModelConfig(**TINY, use_bilateral_grid=True)
    pipeline = SplatPipeline(dm, SplatfactoModel(cfg, scene_scale=1.5))
    st = pipeline.state_from({k: _t(v) for k, v in params.items()},
                             SplatAux(*(_t(getattr(aux, f.name)) for f in dataclasses.fields(SplatAux))))
    metrics, _ = pipeline.get_eval_image_metrics(st, 0)
    plain = float(jmetrics.psnr(jout["rgb"], gt))
    want = float(jmetrics.psnr(jpred, gt))
    assert want > plain
    assert abs(metrics["psnr"] - want) < 2e-3
    assert abs(metrics["ssim"] - float(jmetrics.ssim(jpred, gt))) < 2e-4


def test_checkpoint_round_trip_with_the_per_image_arrays(tmp_path):
    """Bilateral grids and camera-opt tangents (and their moments) saved and
    loaded bit-equal; the resumed run's next step equals the straight
    run's, bit for bit (deterministic algorithms on: the CPU's accumulating
    index_put, the gathers' backward in K8, otherwise adds in parallel)."""
    cfg = SplatfactoModelConfig(**TINY, strategy="mcmc", use_bilateral_grid=True, camera_optimizer_mode="SO3xR3",
                                use_scale_regularization=True)
    rng = np.random.default_rng(13)
    cams = Cameras.create(np.stack([_c2w(0.2 * i) for i in range(N_IMAGES)]), *K, W, H, device=CPU)
    images = _t(rng.uniform(size=(N_IMAGES, H, W, 3)).astype(np.float32))

    def fresh():
        pipeline = SplatPipeline(FullImageDatamanager(cams, images, device=CPU),
                                 SplatfactoModel(cfg, scene_scale=1.5), max_steps=100)
        return pipeline, pipeline.init_state(scene_scale=1.5, draws=jax_init_draws(0, 300), device=CPU)

    torch.use_deterministic_algorithms(True)
    try:
        _round_trip(fresh, tmp_path)
    finally:
        torch.use_deterministic_algorithms(False)


def _round_trip(fresh, tmp_path):
    pipeline, st = fresh()
    assert st.params["bilateral_grids"].shape == (N_IMAGES, 12, 8, 16, 16)
    assert st.params["camera_opt"].shape == (N_IMAGES, 6)
    gen = torch.Generator().manual_seed(1)
    pipeline.train(st, 3, gen)
    assert st.params["camera_opt"].abs().max() > 0
    pipeline.save_checkpoint(st, tmp_path, 3, gen)
    pipeline.train(st, 4, gen)

    pipeline2, st2 = fresh()
    gen2 = torch.Generator()
    pipeline2.load_checkpoint(st2, tmp_path, generator=gen2)
    assert st2.step == 3
    saved = torch.load(sorted(tmp_path.iterdir())[-1], weights_only=False)
    for k in ("bilateral_grids", "camera_opt"):
        assert torch.equal(st2.params[k].detach(), saved["params"][k]), k
    pipeline2.train(st2, 4, gen2)
    for k in st.params:
        assert torch.equal(st.params[k], st2.params[k]), k
        for a, b in zip(st.optimizer._moments(k), st2.optimizer._moments(k)):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("option", ["bilateral", "camera_opt"])
def test_per_image_arrays_need_num_images(option):
    """A config with per-image arrays refuses an init without the image
    count, and makes one row per image with it."""
    from nerfstudio_torch.models.splatfacto import init_gaussian_params

    cfg = SplatfactoModelConfig(**TINY, **OPTIONS[option])
    with pytest.raises(ValueError, match="num_images"):
        init_gaussian_params(cfg, scene_scale=1.5, draws=jax_init_draws(7, 300), device=CPU)
    params, _ = init_gaussian_params(cfg, scene_scale=1.5, draws=jax_init_draws(7, 300), device=CPU,
                                     num_images=N_IMAGES)
    name = "bilateral_grids" if option == "bilateral" else "camera_opt"
    assert params[name].shape[0] == N_IMAGES


def test_zero_rows_leaves_the_per_image_moments():
    """``SplatAdam.zero_rows`` zeroes the masked rows of every array of one
    row per slot and leaves the per-image arrays' moments as they were."""
    from nerfstudio_torch.engine.optimizers import SplatAdam

    g = torch.Generator().manual_seed(3)
    params = {"means": torch.randn(SLOTS, 3, generator=g), "opacities": torch.randn(SLOTS, 1, generator=g),
              "camera_opt": torch.randn(N_IMAGES, 6, generator=g),
              "bilateral_grids": torch.randn(N_IMAGES, 12, 2, 2, 2, generator=g)}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    opt = SplatAdam(params, max_steps=10)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    before = {k: [m.clone() for m in opt._moments(k)] for k in params}
    rows = torch.zeros(SLOTS, dtype=torch.bool)
    rows[:N_IMAGES] = True
    rows[7] = True
    opt.zero_rows(rows)
    for k in params:
        for b, m in zip(before[k], opt._moments(k)):
            if k in ("camera_opt", "bilateral_grids"):
                assert torch.equal(b, m), k
            else:
                assert not m[rows].any() and torch.equal(b[~rows], m[~rows]), k
