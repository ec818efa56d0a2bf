"""Splatfacto's modules in the port against the JAX package on the CPU:
SH colour, SSIM, kNN, random quaternions, the gaussian init, refine slot for
slot, the per-array Adam across a refine, the refine schedule, the eval
render and one whole training step (64x48, 512 slots, sh_degree 3).

Random draws (init uniforms, the background, refine's normals) are JAX's,
handed to the port. Tolerances are stated per test."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import CPU
from nerfstudio_tpu.models.splatfacto import SplatAux as JAux
from nerfstudio_tpu.models.splatfacto import SplatfactoModel as JModel
from nerfstudio_tpu.models.splatfacto import SplatfactoModelConfig as JConfig
from nerfstudio_tpu.models.splatfacto import init_gaussian_params as j_init
from nerfstudio_tpu.pipelines.splat_pipeline import SplatPipeline as JPipeline
from nerfstudio_tpu.pipelines.splat_pipeline import build_splat_optimizers
from nerfstudio_tpu.utils import math as jmath
from nerfstudio_tpu.utils import metrics as jmetrics
from nerfstudio_tpu.utils import spherical_harmonics as jsh
from nerfstudio_torch.data.datamanagers import FullImageDatamanager
from nerfstudio_torch.engine.optimizers import splat_means_lr
from nerfstudio_torch.models.splatfacto import (
    InitDraws,
    SplatAux,
    SplatfactoModel,
    SplatfactoModelConfig,
    _top_m,
    init_gaussian_params,
)
from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline
from nerfstudio_torch.utils import math as tmath
from nerfstudio_torch.utils import metrics as tmetrics
from nerfstudio_torch.utils import spherical_harmonics as tsh
from nerfstudio_torch.utils.convert import splat_state_from_jax

W, H = 64, 48
SLOTS = 512
TINY = dict(max_gaussians=SLOTS, num_random=300, random_init=True, random_scale=1.5, num_downscales=0,
            sh_degree=3, max_refine_new=64)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def _c2w(theta=0.3):
    pos = np.array([2.5 * np.cos(theta), 2.5 * np.sin(theta), 1.2])
    fwd = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, pos], -1).astype(np.float32)


K = (np.float32(1.2 * W), np.float32(1.2 * W), np.float32(W / 2), np.float32(H / 2))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(200, (degree + 1) ** 2, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.eval_sh(degree, _t(coeffs), _t(d)).numpy(),
                               np.asarray(jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(d))),
                               rtol=1e-5, atol=1e-5)
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), rtol=1e-6)
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(_t(rgb))).numpy(), rgb, atol=1e-6)


def test_ssim_matches_jax():
    """1e-5 absolute: the same separable zero-padded filter in float32, summed
    in another order."""
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(40, 33, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a, rng.uniform(size=a.shape).astype(np.float32))):
        assert abs(float(tmetrics.ssim(_t(x), _t(y))) - float(jmetrics.ssim(x, y))) < 1e-5
    assert abs(float(tmetrics.ssim(_t(a), _t(a))) - 1.0) < 1e-6
    assert abs(float(tmetrics.psnr(_t(a), _t(b))) - float(jmetrics.psnr(a, b))) < 1e-4


def test_knn_and_random_quat_match_jax():
    """kNN: indices equal, distances within 1e-6 (both recompute the
    winners' distances from the coordinates); near-duplicate points keep
    exact tiny distances. Quaternions from JAX's uniforms within 1e-6."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    pts[100] = pts[7] + np.float32(1e-4)  # near duplicates
    jd, ji = jmath.k_nearest_neighbors(jnp.asarray(pts), 3)
    td, ti = tmath.k_nearest_neighbors(_t(pts), 3, block=1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert td[7, 0] < 2e-4 and td[100, 0] < 2e-4
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (3, 50)))
    np.testing.assert_allclose(tmath.random_quat(50, uniforms=_t(u)).numpy(),
                               np.asarray(jmath.random_quat(key, 50)), atol=1e-6)


def jax_init_draws(seed: int, n: int) -> InitDraws:
    """The draws of the JAX init_gaussian_params (random init) from its seed."""
    k1, k2, key = jax.random.split(jax.random.PRNGKey(seed), 3)
    k3, _ = jax.random.split(key)
    return InitDraws(_t(jax.random.uniform(k1, (n, 3))), _t(jax.random.uniform(k2, (n, 3))),
                     _t(jax.random.uniform(k3, (3, n))))


def test_init_gaussian_params_matches_jax():
    """Random init padded to max_gaussians with JAX's draws: within 1e-6
    (the log of kNN distances, and the sin/cos of the quaternions)."""
    jcfg, tcfg = JConfig(**TINY), SplatfactoModelConfig(**TINY)
    jp, jaux = j_init(jcfg, scene_scale=1.5, seed=7)
    tp, taux = init_gaussian_params(tcfg, scene_scale=1.5, draws=jax_init_draws(7, 300), device=CPU)
    for k, v in jp.items():
        assert tp[k].shape == v.shape, k
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(taux.alive.numpy(), np.asarray(jaux.alive))
    assert int(taux.alive.sum()) == 300


def test_top_m_breaks_ties_as_xla_top_k():
    """``torch.topk`` gives no order among ties; refine and big_frac need
    XLA's: lower index first."""
    rng = np.random.default_rng(2)
    score = rng.choice(np.array([-1.0, 0.0, 0.5, 1.0], np.float32), 300)
    jv, ji = jax.lax.top_k(jnp.asarray(score), 40)
    tv, ti = _top_m(_t(score), 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _jax_state_arrays(seed=0):
    """A JAX init with anisotropic scales, random quaternions, SH rest
    coefficients and opacities: (params dict of jnp arrays, aux)."""
    jcfg = JConfig(**TINY)
    params, aux = j_init(jcfg, scene_scale=1.5, seed=seed)
    rng = np.random.default_rng(seed)
    alive = np.asarray(aux.alive)
    p = {k: np.array(v) for k, v in params.items()}
    p["scales"][alive] += rng.uniform(-0.4, 0.4, (alive.sum(), 3)).astype(np.float32)
    p["quats"][alive] = rng.normal(size=(alive.sum(), 4)).astype(np.float32)
    p["features_rest"][alive] = rng.normal(0, 0.2, (alive.sum(), 15, 3)).astype(np.float32)
    p["opacities"][alive] = rng.uniform(-3, 3, (alive.sum(), 1)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in p.items()}, aux


def _refine_inputs(seed):
    """Params, Adam state with nonzero moments at count 5, and aux whose
    average gradients tie: several gaussians share one score, and the free
    slots all score 1."""
    params, aux = _jax_state_arrays(seed)
    rng = np.random.default_rng(seed + 10)
    alive = np.asarray(aux.alive)
    grad_accum = np.zeros(SLOTS, np.float32)
    grad_count = np.zeros(SLOTS, np.float32)
    idx = np.nonzero(alive)[0]
    hot = rng.choice(idx, 120, replace=False)
    grad_accum[hot] = rng.choice(np.array([1e-3, 2e-3, 5e-3], np.float32), 120)  # ties
    grad_count[idx] = 1.0
    max_radii = np.where(alive, rng.uniform(0, 0.2, SLOTS), 0).astype(np.float32)
    aux = JAux(alive=jnp.asarray(alive), grad_accum=jnp.asarray(grad_accum), grad_count=jnp.asarray(grad_count),
               max_radii=jnp.asarray(max_radii))
    tx = build_splat_optimizers(JConfig(**TINY), max_steps=100)
    opt_state = tx.init(params)
    leaves, treedef = jax.tree_util.tree_flatten(opt_state)
    leaves = [jnp.full(x.shape, 5, x.dtype) if x.ndim == 0 else
              jnp.asarray(rng.uniform(0.1, 1.0, x.shape).astype(np.float32)) for x in leaves]
    return params, jax.tree_util.tree_unflatten(treedef, leaves), aux


@pytest.mark.parametrize("reset_alpha,use_screen_size", [(False, False), (True, True)])
def test_refine_matches_jax_slot_for_slot(reset_alpha, use_screen_size):
    """Clone, split, cull and (reset) against JAX with JAX's normal draws:
    alive equal; every param slot within 1e-6 (the split offset is a 3x3
    product); moments zeroed on exactly the same rows, the opacity moments
    wiped on a reset, the counts kept."""
    params, opt_state, aux = _refine_inputs(3)
    jcfg = JConfig(**TINY)
    key = jax.random.PRNGKey(11)
    flags = dict(do_split=True, do_cull_scale=True, reset_alpha=reset_alpha, use_screen_size=use_screen_size)
    jp, jo, ja = JModel(jcfg, scene_scale=1.5).refine(params, opt_state, aux, key, **flags)
    state = dict(params=params, opt_state=opt_state, aux=aux, step=np.int32(0))
    tparams, taux, moments, _ = splat_state_from_jax(jax.device_get(state))
    pipeline = SplatPipeline(None, SplatfactoModel(SplatfactoModelConfig(**TINY), scene_scale=1.5), max_steps=100)
    st = pipeline.state_from(tparams, taux, moments)
    k1, k2 = jax.random.split(key)
    normals = (_t(jax.random.normal(k1, (64, 3))), _t(jax.random.normal(k2, (64, 3))))
    pipeline.refine(st, normals, **flags)

    alive0, alive1 = np.asarray(aux.alive), np.asarray(ja.alive)
    np.testing.assert_array_equal(st.aux.alive.numpy(), alive1)
    # it culled (culled slots are the first free ones, so refilled) and wrote
    culled = alive0 & (1 / (1 + np.exp(-np.asarray(params["opacities"])[:, 0])) < 0.1 - 1e-4)
    written = (np.asarray(jp["means"]) != np.asarray(params["means"])).any(-1)
    assert culled.sum() > 10 and written.sum() > 10
    for k, v in jp.items():
        np.testing.assert_allclose(st.params[k].detach().numpy(), np.asarray(v), atol=1e-6, err_msg=k)
    _, _, jmoments, _ = splat_state_from_jax(jax.device_get(dict(state, opt_state=jo)))
    for k, (count, mu, nu) in jmoments.items():
        s = st.optimizer.optimizer.state[st.params[k]]
        assert int(s["step"]) == count == 5
        np.testing.assert_array_equal(s["exp_avg"].numpy(), mu.numpy(), err_msg=k)
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), nu.numpy(), err_msg=k)
    assert (jmoments["opacities"][1].abs().sum() == 0) == reset_alpha
    for k in ("grad_accum", "grad_count", "max_radii"):
        assert not getattr(st.aux, k).any()


def test_adam_matches_optax_across_refine():
    """Three updates with a refine (its moment surgery) after the second:
    params within 1e-6 of optax's, the means rate scheduled by the count."""
    params, _ = _jax_state_arrays(4)
    jcfg = JConfig(**TINY)
    tx = build_splat_optimizers(jcfg, max_steps=100)
    jopt = tx.init(params)
    pipeline = SplatPipeline(None, SplatfactoModel(SplatfactoModelConfig(**TINY), scene_scale=1.5), max_steps=100)
    _, aux0 = j_init(jcfg, scene_scale=1.5, seed=4)
    st = pipeline.state_from({k: _t(v) for k, v in params.items()}, SplatAux(*(_t(getattr(aux0, f.name)) for f in
                                                                              dataclasses.fields(SplatAux))))
    rng = np.random.default_rng(5)
    jparams = params
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, jopt = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, g in grads.items():
            st.params[k].grad = _t(g)
        st.optimizer.step()
        if step == 1:
            aux = JAux(alive=aux0.alive, grad_accum=jnp.where(aux0.alive, 1e-3, 0.0),
                       grad_count=jnp.ones(SLOTS), max_radii=jnp.zeros(SLOTS))
            key = jax.random.PRNGKey(step)
            flags = dict(do_split=True, do_cull_scale=False, reset_alpha=True)
            jparams, jopt, _ = JModel(jcfg, scene_scale=1.5).refine(jparams, jopt, aux, key, **flags)
            k1, k2 = jax.random.split(key)
            normals = (_t(jax.random.normal(k1, (64, 3))), _t(jax.random.normal(k2, (64, 3))))
            st.aux = SplatAux(*(_t(getattr(aux, f.name)) for f in dataclasses.fields(SplatAux)))
            pipeline.refine(st, normals, **flags)
        for k, v in jparams.items():
            np.testing.assert_allclose(st.params[k].detach().numpy(), np.asarray(v), atol=1e-6,
                                       err_msg=f"{k} after update {step}")
    assert st.optimizer.count == 3
    assert math.isclose(splat_means_lr(0, 100), 1.6e-4) and math.isclose(splat_means_lr(100, 100), 1.6e-6)


def test_refine_schedule_follows_jax_train():
    """SplatPipeline.train refines after the step at step > warmup every
    refine_every, resets every reset_alpha_every * refine_every before
    stop_split_at, culls by scale after the first reset period and by screen
    size until stop_screen_size_at (splat_pipeline.py:606-647)."""
    cfg = SplatfactoModelConfig(**TINY)
    images = torch.zeros((2, 8, 8, 3))
    from nerfstudio_torch.cameras.cameras import Cameras

    cams = Cameras.create(np.stack([_c2w(0.0), _c2w(1.0)]), 8.0, 8.0, 4.0, 4.0, 8, 8, device=CPU)
    pipeline = SplatPipeline(FullImageDatamanager(cams, images, device=CPU), SplatfactoModel(cfg))
    calls = []
    pipeline.train_step = lambda state, *a, **kw: setattr(state, "step", state.step + 1) or {}
    pipeline.refine = lambda state, normals, **flags: calls.append((state.step - 1, flags))

    class S:
        step = 0

    st = S()
    for step in (500, 501, 600, 3000, 3100, 4000, 6000, 14900, 15000, 15100):
        st.step = step
        pipeline.train(st, step + 1)
    got = {s: (f["do_split"], f["do_cull_scale"], f["reset_alpha"], f["use_screen_size"]) for s, f in calls}
    assert got == {
        600: (True, False, False, False),
        3000: (True, False, True, False),
        3100: (True, True, False, True),
        4000: (True, True, False, False),
        6000: (True, True, True, False),
        14900: (True, True, False, False),
        15000: (False, True, False, False),
        15100: (False, True, False, False),
    }
    model = SplatfactoModel(dataclasses.replace(cfg, num_downscales=2))
    jmodel = JModel(dataclasses.replace(JConfig(**TINY), num_downscales=2))
    for step in (0, 999, 1000, 2999, 3000, 6000, 9000):
        assert model.sh_degree_at(step) == jmodel.sh_degree_at(step)
        assert model.downscale_at(step) == jmodel.downscale_at(step)


def test_train_downscales_image_and_intrinsics_as_jax():
    """At step 0 with num_downscales 2 the step sees the image at a quarter
    of its size, resized as jax.image.resize "linear" (antialiased) resizes
    it, within 1e-6, and K / 4 in float32 (splat_pipeline.py:588-596)."""
    from nerfstudio_torch.cameras.cameras import Cameras

    cfg = SplatfactoModelConfig(**{**TINY, "num_downscales": 2})
    rng = np.random.default_rng(8)
    image = rng.uniform(size=(1, 48, 64, 3)).astype(np.float32)
    cams = Cameras.create(_c2w()[None], *K, W, H, device=CPU)
    pipeline = SplatPipeline(FullImageDatamanager(cams, _t(image), device=CPU), SplatfactoModel(cfg))
    seen = {}
    pipeline.train_step = lambda state, c2w, k, img, bg, w, h, sh, **kw: seen.update(k=k, img=img, wh=(w, h),
                                                                                     sh=sh) or {}
    pipeline.train(pipeline.init_state(draws=jax_init_draws(0, 300), device=CPU), 1,
                   torch.Generator().manual_seed(0))
    assert seen["wh"] == (16, 12) and seen["sh"] == 0
    np.testing.assert_array_equal(np.array(seen["k"], np.float32), np.array(K, np.float32) / np.float32(4))
    want = np.asarray(jax.image.resize(jnp.asarray(image[0]), (12, 16, 3), "linear"))
    np.testing.assert_allclose(seen["img"].numpy(), want, atol=1e-6)


def test_datamanager_camera_order_is_the_seeded_permutation():
    from nerfstudio_torch.cameras.cameras import Cameras

    images = torch.arange(5, dtype=torch.uint8).view(5, 1, 1, 1).expand(5, 2, 2, 3).contiguous()
    cams = Cameras.create(np.stack([_c2w(t) for t in range(5)]), 2.0, 2.0, 1.0, 1.0, 2, 2, device=CPU)
    dm = FullImageDatamanager(cams, images, seed=3, device=CPU)
    rng = np.random.default_rng(3)
    want = list(rng.permutation(5)) + list(rng.permutation(5))
    got = [dm.next_train(i) for i in range(10)]
    assert [i for i, _ in got] == want
    assert all(img.dtype == torch.float32 and float(img[0, 0, 0]) == np.float32(i) / np.float32(255) for i, img in got)


def test_full_image_uint8_is_the_quotient_by_255():
    """Every uint8 value of a train and an eval image reaches the step as
    np.float32(v) / 255 exactly, through the CPU-made table the card
    gathers from too (a CUDA division by a scalar is 1 ulp off it for some
    values)."""
    from nerfstudio_torch.cameras.cameras import Cameras

    img = torch.arange(256, dtype=torch.uint8).view(1, 16, 16, 1).expand(1, 16, 16, 3).contiguous()
    cams = Cameras.create(_c2w()[None], 16.0, 16.0, 8.0, 8.0, 16, 16, device=CPU)
    dm = FullImageDatamanager(cams, img, cams, img, device=CPU)
    want = np.arange(256, dtype=np.float32).reshape(16, 16) / np.float32(255)
    for got in (dm.next_train(0)[1], dm.eval_image(0)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got[..., 1].numpy(), want)


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX train steps from a structured init (the first so the moments
    are not at zero): (state before the second step as numpy, its metrics,
    the state after, the background draw of the second step)."""
    params, aux = _jax_state_arrays(6)

    class DM:
        class train_dataset:
            def __len__(self):
                return 4

        train_dataset = train_dataset()

    jcfg = JConfig(**TINY)
    pipe = JPipeline(DM(), JModel(jcfg, scene_scale=1.5), max_steps=30000)
    state = pipe.init_state(scene_scale=1.5, seed=6, n_cap_override=SLOTS)
    state = state.replace(params=params, opt_state=pipe.tx.init(params))
    step = pipe.build_train_step()
    rng = np.random.default_rng(7)
    gts = [rng.uniform(size=(H, W, 3)).astype(np.float32) for _ in range(2)]
    state, _ = step(state, _c2w(0.3), np.array(K, np.float32), jnp.asarray(gts[0]), jax.random.PRNGKey(0),
                    width=W, height=H, sh_degree=3)
    before = jax.device_get(state)
    key = jax.random.PRNGKey(1)
    after, metrics = step(state, _c2w(0.9), np.array(K, np.float32), jnp.asarray(gts[1]), key,
                          width=W, height=H, sh_degree=3)
    bg = np.asarray(jax.random.uniform(jax.random.split(key)[0], (3,)))
    return before, {k: float(v) for k, v in metrics.items()}, jax.device_get(after), bg, gts[1]


def test_train_step_matches_jax(jax_steps):
    """One step from JAX's state (splat_state_from_jax) with JAX's
    background. The loss within 1e-5 relative. Each array's gradient
    (JAX's recovered from its first moments) within 1e-3 of its peak: K6's
    per-pixel cutoff, where the reference blends on to its chunk's end.
    Adam scales every element's step to ~lr however small its gradient, so
    a gaussian whose only gradient comes from entries behind the cutoff
    steps differently on the two sides: updates are held, within 1e-2 of
    the array's largest update, where the gradient is at least 1e-2 of its
    peak (a relative gradient error below 1e-1 there), and the rest by their
    gradients. Moments within 1e-3 of their peak. Densification stats:
    grad_count and max_radii equal, grad_accum within 1e-3 of its peak."""
    before, jmetrics_, after, bg, gt = jax_steps
    params, aux, moments, step = splat_state_from_jax(before)
    pipeline = SplatPipeline(None, SplatfactoModel(SplatfactoModelConfig(**TINY), scene_scale=1.5))
    st = pipeline.state_from(params, aux, moments, step)
    metrics = pipeline.train_step(st, _t(_c2w(0.9)), tuple(float(k) for k in K), _t(gt), _t(bg), W, H, 3)
    assert abs(float(metrics["loss"]) - jmetrics_["loss"]) <= 1e-5 * abs(jmetrics_["loss"])
    for k in ("l1", "ssim_loss", "psnr", "num_alive"):
        assert math.isclose(float(metrics[k]), jmetrics_[k], rel_tol=1e-4), k
    assert st.step == int(after.step) == 2
    _, _, jmom, _ = splat_state_from_jax(after)
    for k, v in after.params.items():
        g_jax = ((jmom[k][1] - 0.9 * moments[k][1]) / 0.1).numpy()
        peak = np.abs(g_jax).max()
        assert np.abs(st.params[k].grad.numpy() - g_jax).max() <= 1e-3 * peak, k
        new, old = np.asarray(v), params[k].numpy()
        strong = np.abs(g_jax) >= 1e-2 * peak
        assert strong.sum() >= 5, k
        got = st.params[k].detach().numpy()
        assert np.abs(got - new)[strong].max() <= 1e-2 * np.abs(new - old).max(), k
    for k, (count, mu, nu) in jmom.items():
        s = st.optimizer.optimizer.state[st.params[k]]
        assert int(s["step"]) == count == 2
        for got, want in ((s["exp_avg"], mu), (s["exp_avg_sq"], nu)):
            assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), k
    np.testing.assert_array_equal(st.aux.grad_count.numpy(), np.asarray(after.aux.grad_count))
    np.testing.assert_array_equal(st.aux.max_radii.numpy(), np.asarray(after.aux.max_radii))
    ga = np.asarray(after.aux.grad_accum)
    assert np.abs(st.aux.grad_accum.numpy() - ga).max() <= 1e-3 * ga.max()


@pytest.mark.parametrize("mode", ["classic", "antialiased"])
def test_eval_render_and_metrics_match_jax(jax_steps, mode):
    """render_eval_image at the full SH degree over a black background, and
    its PSNR and SSIM, against the JAX model's render, in both rasterize
    modes: images within 2e-4 (the blend's cutoff), PSNR within 1e-3 dB and
    SSIM within 1e-4, what such pixel differences move them by."""
    before, _, _, _, gt = jax_steps
    params, aux, _, _ = splat_state_from_jax(before)
    jcfg = JConfig(**TINY, rasterize_mode=mode)
    jout = JModel(jcfg, scene_scale=1.5).render(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()}, jnp.asarray(aux.alive.numpy()),
        jnp.asarray(_c2w(0.9)), K, W, H, sh_degree_active=3, background=jnp.zeros(3))
    from nerfstudio_torch.cameras.cameras import Cameras

    cams = Cameras.create(_c2w(0.9)[None], *K, W, H, device=CPU)
    dm = FullImageDatamanager(cams, _t(gt)[None], device=CPU)
    pipeline = SplatPipeline(dm, SplatfactoModel(SplatfactoModelConfig(**TINY, rasterize_mode=mode), scene_scale=1.5))
    st = pipeline.state_from(params, aux)
    metrics, out = pipeline.get_eval_image_metrics(st, 0)
    for k in ("rgb", "accumulation"):
        assert np.abs(out[k].numpy() - np.asarray(jout[k])).max() <= 2e-4, k
    assert abs(metrics["psnr"] - float(jmetrics.psnr(jout["rgb"], gt))) < 1e-3
    assert abs(metrics["ssim"] - float(jmetrics.ssim(jout["rgb"], gt))) < 1e-4


@pytest.mark.parametrize("option", [
    dict(strategy="mcmc"), dict(use_bilateral_grid=True), dict(camera_optimizer_mode="SO3xR3"),
    dict(use_scale_regularization=True), dict(blend_mode="bounded"),
])
def test_unported_options_raise(option):
    """``blend_mode="bounded"`` is still refused; each option ported since
    builds and takes one finite step on the CPU through ``train`` (the
    per-image arrays made for the datamanager's two cameras)."""
    if option.get("blend_mode") == "bounded":
        with pytest.raises(NotImplementedError):
            SplatfactoModel(SplatfactoModelConfig(**TINY, **option))
        return
    from nerfstudio_torch.cameras.cameras import Cameras

    cfg = SplatfactoModelConfig(**TINY, **option)
    rng = np.random.default_rng(9)
    cams = Cameras.create(np.stack([_c2w(0.3), _c2w(0.9)]), *K, W, H, device=CPU)
    dm = FullImageDatamanager(cams, _t(rng.uniform(size=(2, H, W, 3)).astype(np.float32)), device=CPU)
    pipeline = SplatPipeline(dm, SplatfactoModel(cfg, scene_scale=1.5), max_steps=100)
    st = pipeline.init_state(scene_scale=1.5, draws=jax_init_draws(0, 300), device=CPU)
    assert ("bilateral_grids" in st.params) == cfg.use_bilateral_grid
    assert ("camera_opt" in st.params) == (cfg.camera_optimizer_mode != "off")
    before = {k: v.detach().clone() for k, v in st.params.items()}
    _, metrics = pipeline.train(st, 1, torch.Generator().manual_seed(0))
    assert st.step == 1 and math.isfinite(float(metrics["loss"]))
    assert all(torch.isfinite(v).all() for v in st.params.values())
    assert not torch.equal(before["means"], st.params["means"])
