"""Parity of the training slice's modules with the JAX reference, on
identical inputs drawn with numpy (or by JAX and handed over): trunc_exp's
clamped gradient, the SO3xR3/SE3 exponential maps and the camera optimizer,
the interlevel and distortion losses, per-group Adam against optax, the
occupancy-grid update, and the nerfacto field's training forward and
backward. Also the field's hash path follows its mode (K1 in training, K3 at
eval) on every call.

Tolerances are stated per test. Pure float32 math (exp maps, losses, Adam,
occupancy) runs the same operations in another order: rtol 1e-5 (1e-4 on
Adam's parameter deltas, which divide by sqrt(v) + 1e-15)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import CPU, NO_HASH_LAUNCHES, init_params, jax_occupancy_draws, to_torch
from nerfstudio_tpu.cameras import camera_optimizers as jcopt
from nerfstudio_tpu.cameras import lie_groups as jlie
from nerfstudio_tpu.configs.method_configs import _nerfacto_optimizers
from nerfstudio_tpu.core.rays import Frustums as JFrustums
from nerfstudio_tpu.core.rays import RayBundle as JRayBundle
from nerfstudio_tpu.core.rays import RaySamples as JRaySamples
from nerfstudio_tpu.engine.optimizers import build_optimizers, current_learning_rates
from nerfstudio_tpu.field_components.activations import trunc_exp as j_trunc_exp
from nerfstudio_tpu.field_components.field_heads import FieldHeadNames as JNames
from nerfstudio_tpu.fields.nerfacto_field import NerfactoField as JNerfactoField
from nerfstudio_tpu.model_components import losses as jlosses
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_torch.cameras import camera_optimizers as tcopt
from nerfstudio_torch.cameras import lie_groups as tlie
from nerfstudio_torch.core.rays import Frustums, RayBundle, RaySamples
from nerfstudio_torch.engine.optimizers import PerGroupAdam, nerfacto_optimizers
from nerfstudio_torch.field_components.activations import trunc_exp
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.model_components import losses as tlosses
from nerfstudio_torch.ops import hash_grid as thg
from nerfstudio_torch.ops import occupancy as tocc
from nerfstudio_torch.utils.convert import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def test_trunc_exp_gradient_is_clamped():
    x = np.array([-50, -15.5, -1, 0, 1, 14.9, 15.5, 29.9, 31, 1e4], np.float32)
    g = np.arange(1, x.size + 1, dtype=np.float32)
    ref = jax.vjp(j_trunc_exp, jnp.asarray(x))[1](jnp.asarray(g))[0]
    tx = to_torch(x).requires_grad_()
    trunc_exp(tx).backward(to_torch(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), **TOL)
    assert np.isfinite(tx.grad.numpy()).all()


def _tangents(n, seed):
    """Random tangents plus the Taylor branch (theta^2 < 1e-8) and zero."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    t[0] = 0.0
    t[1, 3:] = [3e-5, -2e-5, 1e-5]
    t[2, 3:] = [2.0, -1.0, 0.5]
    return t


@pytest.mark.parametrize("name", ["exp_map_SO3xR3", "exp_map_SE3"])
def test_exp_maps_values_and_gradients(name):
    t = _tangents(64, 0)
    w = np.random.default_rng(1).normal(0, 1, (64, 3, 4)).astype(np.float32)
    jfn, tfn = getattr(jlie, name), getattr(tlie, name)
    ref, vjp = jax.vjp(jfn, jnp.asarray(t))
    tt = to_torch(t).requires_grad_()
    got = tfn(tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    got.backward(to_torch(w))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), rtol=1e-4, atol=1e-5)
    assert np.isfinite(tt.grad.numpy()).all()


def test_camera_optimizer_apply_and_gradient():
    """SO3xR3 with zero_mean_gauge, applied to a ray bundle: origins,
    directions, and the gradient to pose_adjustment of a weighted sum of
    both (the gauge couples every camera's gradient)."""
    rng = np.random.default_rng(2)
    n_cam, n = 4, 200
    adj = rng.normal(0, 0.05, (n_cam, 6)).astype(np.float32)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = rng.integers(0, n_cam - 1, (n, 1)).astype(np.int32)  # camera 3 sees no ray
    a, b = rng.normal(0, 1, (2, n, 3)).astype(np.float32)
    jco = jcopt.CameraOptimizer(num_cameras=n_cam, mode="SO3xR3", zero_mean_gauge=True)
    jrb = JRayBundle(origins=o, directions=d, pixel_area=np.ones((n, 1), np.float32), camera_indices=cam)

    def jloss(p):
        rb = jco.apply({"params": {"pose_adjustment": p}}, jrb, method=jcopt.CameraOptimizer.apply_to_raybundle)
        return jnp.sum(rb.origins * a) + jnp.sum(rb.directions * b), rb

    (_, jrb2), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(adj))
    tco = tcopt.CameraOptimizer(num_cameras=n_cam, mode="SO3xR3", zero_mean_gauge=True, device=CPU)
    with torch.no_grad():
        tco.pose_adjustment.copy_(to_torch(adj))
    trb = tco.apply_to_raybundle(RayBundle(to_torch(o), to_torch(d), torch.ones(n, 1), camera_indices=to_torch(cam)))
    np.testing.assert_allclose(trb.origins.detach().numpy(), np.asarray(jrb2.origins), **TOL)
    np.testing.assert_allclose(trb.directions.detach().numpy(), np.asarray(jrb2.directions), **TOL)
    (torch.sum(trb.origins * to_torch(a)) + torch.sum(trb.directions * to_torch(b))).backward()
    np.testing.assert_allclose(tco.pose_adjustment.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(jgrad)[3]).max() > 0  # the gauge reaches the unseen camera


@pytest.mark.parametrize("scale", [0.0, 0.05])
def test_camera_opt_regularizer(scale):
    """Value and gradient, finite at the all-zero init (the safe norm)."""
    adj = np.random.default_rng(3).normal(0, scale, (5, 6)).astype(np.float32)
    ref, jg = jax.value_and_grad(lambda p: jcopt.camera_opt_regularizer(p, 1e-2, 1e-3))(jnp.asarray(adj))
    tp = to_torch(adj).requires_grad_()
    got = tcopt.camera_opt_regularizer(tp, 1e-2, 1e-3)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)


def _histograms(rng, rays, n_prop, n_field):
    """(proposal and field) bins in [0, 1], sorted, and weights."""
    def bins(n):
        b = np.sort(rng.uniform(0, 1, (rays, n + 1)), axis=-1).astype(np.float32)
        b[:, 0], b[:, -1] = 0.0, 1.0
        return b

    bp, bf = bins(n_prop), bins(n_field)
    bf[:5, 3] = bf[:5, 2]  # zero-width bins
    bf[5:10, 1:4] = bp[5:10, 1:4]  # edges shared with the proposal histogram: the searchsorted sides matter
    bf[5:10] = np.sort(bf[5:10], axis=-1)
    wp = rng.uniform(0, 1, (rays, n_prop, 1)).astype(np.float32)
    wf = (rng.uniform(0, 1, (rays, n_field, 1)) ** 3).astype(np.float32)
    return bp, bf, wp, wf


def _samples_from_bins(b, jax_side):
    n = b.shape[0]
    z = np.zeros(b.shape[:1] + (b.shape[1] - 1, 1), np.float32)
    starts, ends = b[:, :-1, None], b[:, 1:, None]
    if jax_side:
        fr = JFrustums(origins=np.zeros(z.shape[:-1] + (3,), np.float32), directions=np.zeros(z.shape[:-1] + (3,), np.float32),
                       starts=starts, ends=ends, pixel_area=z + 1)
        return JRaySamples(frustums=fr, spacing_starts=starts, spacing_ends=ends)
    fr = Frustums(torch.zeros(z.shape[:-1] + (3,)), torch.zeros(z.shape[:-1] + (3,)), to_torch(starts), to_torch(ends),
                  torch.ones(z.shape))
    return RaySamples(frustums=fr, spacing_starts=to_torch(starts), spacing_ends=to_torch(ends))


def test_interlevel_and_distortion_losses_values_and_gradients():
    """Same histograms, same values (rtol 1e-5) and gradients to the
    weights (rtol 1e-4, atol 1e-7 of sums over 33-64 bins); the interlevel
    target (the field histogram) gets no gradient on either side."""
    rng = np.random.default_rng(4)
    bp, bf, wp, wf = _histograms(rng, 256, 64, 32)

    def jfn(wp_, wf_):
        wl = [wp_, wf_]
        rl = [_samples_from_bins(bp, True), _samples_from_bins(bf, True)]
        return jlosses.interlevel_loss(wl, rl), jlosses.distortion_loss(wl, rl)

    (j_il, j_dist), vjp = jax.vjp(jfn, jnp.asarray(wp), jnp.asarray(wf))
    twp, twf = to_torch(wp).requires_grad_(), to_torch(wf).requires_grad_()
    rl = [_samples_from_bins(bp, False), _samples_from_bins(bf, False)]
    t_il = tlosses.interlevel_loss([twp, twf], rl)
    t_dist = tlosses.distortion_loss([twp, twf], rl)
    np.testing.assert_allclose(t_il.item(), float(j_il), rtol=1e-5)
    np.testing.assert_allclose(t_dist.item(), float(j_dist), rtol=1e-5)
    for ct in ((1.0, 0.0), (0.0, 1.0)):
        jg = vjp((jnp.float32(ct[0]), jnp.float32(ct[1])))
        twp.grad = twf.grad = None
        (ct[0] * tlosses.interlevel_loss([twp, twf], rl) + ct[1] * tlosses.distortion_loss([twp, twf], rl)).backward()
        for tg, g in ((twp.grad, jg[0]), (twf.grad, jg[1])):
            got = np.zeros_like(np.asarray(g)) if tg is None else tg.numpy()
            np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4, atol=1e-7)


def _adam_trees(rng):
    shapes = {"field": {"w": (5, 3), "b": (3,)}, "proposal_networks_0": {"w": (4, 2)}, "camera_optimizer": {"pose_adjustment": (3, 6)}}
    return {g: {k: rng.normal(0, 1, s).astype(np.float32) for k, s in m.items()} for g, m in shapes.items()}


class _Groups(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for g, m in params.items():
            setattr(self, g, torch.nn.ParameterDict({k: torch.nn.Parameter(to_torch(v)) for k, v in m.items()}))


def test_per_group_adam_matches_optax():
    """Three steps of nerfacto's per-group Adam (eps 1e-15) against optax's
    multi_transform on the same gradients, with a decay short enough
    (max_steps=4) that each step's rate differs. The proposal group gets a
    gradient only on the first step: optax steps it on zeros afterwards
    (its momentum keeps moving it), and the port must too, with its
    ``.grad`` left None. Parameters agree to rtol 1e-5, atol 1e-7."""
    rng = np.random.default_rng(5)
    params = {"params": _adam_trees(rng)}
    grads = [{"params": _adam_trees(rng)} for _ in range(3)]
    for g in grads[1:]:
        g["params"]["proposal_networks_0"] = jax.tree_util.tree_map(np.zeros_like, g["params"]["proposal_networks_0"])
    jcfg = _nerfacto_optimizers(max_steps=4)
    tx = build_optimizers(jcfg, params)
    opt_state = tx.init(params)
    jp = params
    model = _Groups(params["params"])
    opt = PerGroupAdam(nerfacto_optimizers(max_steps=4), model)
    for step, g in enumerate(grads):
        assert opt.learning_rates() == pytest.approx(current_learning_rates(jcfg, step), rel=1e-6)
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for gname, m in g["params"].items():
            if gname == "proposal_networks_0" and step > 0:
                continue  # no gradient at all on the port's side
            for k, v in m.items():
                getattr(model, gname)[k].grad = to_torch(v)
        opt.step()
        for gname, m in jp["params"].items():
            for k, v in m.items():
                np.testing.assert_allclose(getattr(model, gname)[k].detach().numpy(), np.asarray(v), rtol=1e-5,
                                           atol=1e-7, err_msg=f"step {step} {gname}/{k}")
    moved = np.asarray(jp["params"]["proposal_networks_0"]["w"]) - params["params"]["proposal_networks_0"]["w"]
    assert np.abs(moved).min() > 0


def test_schedule_follows_the_optimizers_count_not_the_step():
    """A fresh optimizer at trainer step 6000 (as bench.py starts one)
    applies lr_init: the schedule is indexed by the optimizer's count."""
    model = _Groups(_adam_trees(np.random.default_rng(6)))
    opt = PerGroupAdam(nerfacto_optimizers(), model)
    assert opt.learning_rates() == pytest.approx({"field": 1e-2, "proposal_networks": 1e-2, "camera_optimizer": 6e-4})


def _density(p):
    """A density every framework here computes alike: a bump around the
    centre, (..., 3) -> (..., 1)."""
    if isinstance(p, torch.Tensor):
        return 5.0 * torch.exp(-40.0 * ((p - 0.5) ** 2).sum(-1, keepdim=True))
    lib = jnp if isinstance(p, jax.Array) else np
    return 5.0 * lib.exp(-40.0 * lib.sum((p - 0.5) ** 2, axis=-1, keepdims=True))


def _occupancy_pair(res, seed):
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0, 2e-3, res**3).astype(np.float32)  # around the 1e-3 threshold
    jgrid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res)
    jgrid = jgrid.replace(densities=jnp.asarray(dens), density_rows=jocc._pack_rows(jnp.asarray(dens), res))
    tgrid = tocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res, CPU)
    tgrid.densities = to_torch(dens)
    return jgrid, tgrid


def test_occupancy_update_matches_on_unique_cells():
    """Every cell refreshed once (the update covers the grid): densities
    within rtol 1e-5, the same threshold and binary grid."""
    res = 16
    jgrid, tgrid = _occupancy_pair(res, 7)
    key = jax.random.PRNGKey(8)
    jnew = jocc.update_occupancy_grid(jgrid, _density, key, occ_thre=1e-3, ema_decay=0.95)
    cells, jitter = jax_occupancy_draws(key, res, res**3)
    tnew = tocc.update_occupancy_grid(tgrid, _density, occ_thre=1e-3, ema_decay=0.95, cells=cells, jitter=jitter)
    np.testing.assert_allclose(tnew.densities.numpy(), np.asarray(jnew.densities), **TOL)
    np.testing.assert_array_equal(tnew.binary.numpy(), np.asarray(jnew.binary))
    assert 0.02 < tnew.binary.float().mean() < 0.98
    # the threshold: min(mean, occ_thre)
    thresh = min(float(tnew.densities.mean()), 1e-3)
    np.testing.assert_array_equal(tnew.binary.numpy(), tnew.densities.numpy() > thresh)
    assert tgrid.densities.numpy().max() <= 2e-3  # the old state is not modified


def test_occupancy_update_subset_and_repeated_cells():
    """A subset drawn with replacement, as the reference draws it: cells
    drawn once match JAX; a repeated cell keeps the largest of its refreshed
    values in the port (the reference leaves the winner unspecified);
    cells not drawn keep their old density."""
    res, k = 8, 400
    jgrid, tgrid = _occupancy_pair(res, 9)
    key = jax.random.PRNGKey(10)
    jnew = jocc.update_occupancy_grid(jgrid, _density, key, occ_thre=1e-3, cells_per_update=k)
    cells, jitter = jax_occupancy_draws(key, res, k)
    tnew = tocc.update_occupancy_grid(tgrid, _density, cells=cells, jitter=jitter, occ_thre=1e-3)
    counts = np.bincount(cells.numpy(), minlength=res**3)
    assert (counts > 1).any() and (counts == 1).any() and (counts == 0).any()
    once = counts == 1
    np.testing.assert_allclose(tnew.densities.numpy()[once], np.asarray(jnew.densities)[once], **TOL)
    untouched = counts == 0
    np.testing.assert_array_equal(tnew.densities.numpy()[untouched], tgrid.densities.numpy()[untouched])
    ijk = (cells.numpy()[:, None] // np.array([res * res, res, 1])) % res
    refreshed = np.maximum(tgrid.densities.numpy()[cells.numpy()] * 0.95,
                           _density(((ijk + jitter.numpy()) / res).astype(np.float32))[:, 0])
    best = np.full(res**3, -np.inf, np.float32)
    np.maximum.at(best, cells.numpy(), refreshed.astype(np.float32))
    many = counts > 1
    np.testing.assert_allclose(tnew.densities.numpy()[many], best[many], **TOL)


FIELD_KW = dict(num_images=4, num_levels=4, base_res=4, max_res=64, log2_hashmap_size=12, features_per_level=4,
                hidden_dim=16, hidden_dim_color=16, appearance_embedding_dim=8, average_init_density=1.0,
                hash_block=True, exact_eval=True)


def _train_samples(n, seed):
    """Ray samples with camera indices: positions inside and outside the
    unit ball, unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s = rng.uniform(0, 0.5, (n, 1)).astype(np.float32)
    e = s + rng.uniform(0, 0.1, (n, 1)).astype(np.float32)
    cam = rng.integers(0, 4, (n, 1)).astype(np.int32)
    one = np.ones((n, 1), np.float32)
    jrs = JRaySamples(frustums=JFrustums(origins=o, directions=d, starts=s, ends=e, pixel_area=one), camera_indices=cam)
    trs = RaySamples(frustums=Frustums(*(to_torch(x) for x in (o, d, s, e, one))), camera_indices=to_torch(cam))
    return jrs, trs


def _flat_grads(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("bwd", [None, (0, 2)], ids=["all_levels", "P2_levels_0_2"])
def test_nerfacto_field_training_forward_and_backward(bwd):
    """The field in training mode (K1, per-camera appearance embedding) on
    identical RaySamples: outputs, and the gradient of a weighted sum of
    rgb and density to every parameter. K1 takes the same blocks on both
    sides (same float32 positions), so the table gradients compare entry by
    entry. The MLPs run in bf16 on both sides and round products in another
    order, so outputs are held to 1e-2 and gradients to 2e-2 of each
    parameter's largest entry."""
    jrs, trs = _train_samples(3000, 11)
    jf = JNerfactoField(train=True, **FIELD_KW)
    params = init_params(lambda k: jf.init(k, jrs), 12)
    rng = np.random.default_rng(13)
    a = rng.normal(0, 1, (3000, 3)).astype(np.float32)
    b = rng.normal(0, 1, (3000, 1)).astype(np.float32)
    scale = 2.0 if bwd else 1.0

    def jloss(p):
        out = jf.apply(p, jrs, bwd_levels=bwd, bwd_scale=scale)
        rgb, density = out[JNames.RGB], out[JNames.DENSITY]
        return jnp.sum(rgb * a) + jnp.sum(jnp.tanh(density) * b), (rgb, density)

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    tf = NerfactoField(device=CPU, **FIELD_KW).train()
    tf.load_state_dict(params_from_jax(params, tf))
    thg.reset_launch_counts()
    out = tf(trs, bwd_levels=bwd, bwd_scale=scale)
    (torch.sum(out[FieldHeadNames.RGB] * to_torch(a)) + torch.sum(torch.tanh(out[FieldHeadNames.DENSITY]) * to_torch(b))).backward()
    np.testing.assert_allclose(out[FieldHeadNames.RGB].detach().numpy(), np.asarray(jout[0]), rtol=0, atol=1e-2)
    dens, jdens = out[FieldHeadNames.DENSITY].detach().numpy(), np.asarray(jout[1])
    np.testing.assert_allclose(dens, jdens, rtol=5e-2, atol=1e-3)
    tgrads = {n: p.grad for n, p in tf.named_parameters()}
    jg = params_from_jax(jax.device_get(jgrad), tf)
    assert set(tgrads) == set(jg)
    for name, g in tgrads.items():
        ref = jg[name].numpy()
        assert g is not None, name
        peak = np.abs(ref).max()
        assert peak > 0 or name.endswith("hash_table"), name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=2e-2 * peak + 1e-12, err_msg=name)
    table = tgrads["mlp_base.encoding.hash_table"].numpy()
    for l in range(FIELD_KW["num_levels"]):
        assert bool(table[l].any()) == (bwd is None or l in bwd), l
    # the appearance embedding of cameras that no sample shows gets nothing
    assert thg.launch_counts == NO_HASH_LAUNCHES


def test_field_hash_path_follows_the_mode(monkeypatch):
    """Fault repaired: the field picked K3 at construction, so a model put
    in training still ran the exact eval trilerp. Now every call reads the
    mode: K1 in training (and in the occupancy update's
    ``density_from_normalized``), K3 at eval, back to K1 in training. CPU
    tensors take the twins, which a spy counts here; chip_smoke.py counts
    the kernels' launches per mode on the card."""
    calls = {"k1": 0, "k3": 0}
    k1, k3 = thg._block_stochastic_twin, thg._block_exact_twin

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(thg, "_block_stochastic_twin", spy("k1", k1))
    monkeypatch.setattr(thg, "_block_exact_twin", spy("k3", k3))
    tf = NerfactoField(device=CPU, **FIELD_KW)
    _, trs = _train_samples(64, 14)
    expected = []
    for mode in ("train", "eval", "train"):
        getattr(tf, mode)()
        before = dict(calls)
        with torch.set_grad_enabled(mode == "train"):
            tf(trs)
        expected.append({k: calls[k] - before[k] for k in calls})
    assert expected == [{"k1": 1, "k3": 0}, {"k1": 0, "k3": 1}, {"k1": 1, "k3": 0}]
    tf.train()
    before = dict(calls)
    tf.density_from_normalized(torch.rand(32, 3))
    assert calls["k1"] - before["k1"] == 1 and calls["k3"] == before["k3"]
