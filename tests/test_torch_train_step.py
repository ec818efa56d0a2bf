"""The training slice end to end: the tiny nerfacto trained by the JAX
pipeline's ``train_step`` and by the port's, from the same converted
params, occupancy grid and images, with JAX's per-step draws (pixel
indices, probe jitter, both PDF jitters, occupancy cells and jitter) handed
to the port.

Two points of the schedule (``step_kwargs``) are run, three steps each:
``early`` from step 304 (occupancy update, full field backward, live
proposals) and ``steady`` from step 6000 (occupancy update, frozen
proposals, the level-subsampled field backward on levels 0 and 2 with
scale 2). Steps advance by 2 so each point compiles one JAX program.

K1 redraws its odd-axis rounding on any ulp change of a sample position,
and the two packages sum the PDF weights in another order, so with live
tables the forwards differ wherever a sample redraws. The main cases flatten
both hash tables to one value per (level, feature), a variant of the render
test's ``k1_neutral`` trick: K1 then returns that value whichever corners it
picks (the corner weights sum to 1), and each table's gradient, summed per
level and feature, is ``scale_l * sum of the encoding's cotangent``,
whichever corners got it. (All-zero tables would not do: with the init's
zero biases the field's first ReLU then passes no gradient at all.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    CPU,
    HW,
    NO_HASH_LAUNCHES,
    NUM_IMAGES,
    init_params,
    jax_occupancy_draws,
    jax_step_draws,
    jax_tiny_nerfacto,
    sphere_grid_binary,
    torch_tiny_nerfacto,
)
from nerfstudio_tpu.engine.optimizers import build_optimizers
from nerfstudio_tpu.model_components.ray_generators import generate_rays_from_indices as j_rays_from_indices
from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_tpu.pipelines.base_pipeline import VanillaPipeline as JPipeline
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
from nerfstudio_torch.engine.optimizers import PerGroupAdam, nerfacto_optimizers
from nerfstudio_torch.models.nerfacto import NerfactoModel
from nerfstudio_torch.ops import hash_grid
from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline
from nerfstudio_torch.utils.convert import params_from_jax, train_state_from_jax

RAYS = 64
SCENARIOS = {"early": 304, "steady": 6000}
TABLES = ("field.mlp_base.encoding.hash_table", "proposal_networks.0.mlp_base.encoding.hash_table")


@pytest.fixture(scope="module")
def world():
    return _build_world()


def _build_world():
    """The JAX side (synthetic images and cameras of bench.py's setup, the
    tiny training model, its params, a sphere grid, its pipeline and a jitted
    loss-and-gradient of its train step) and the port's data manager."""
    from __graft_entry__ import _synthetic_setup

    cfg, dm, _, _ = _synthetic_setup(hw=HW, n_images=NUM_IMAGES, rays=RAYS, tiny=True)
    jmodel, jcfg = jax_tiny_nerfacto(train=True)
    idx, _ = dm.sample_train_batch(jax.random.PRNGKey(0), dm.train_images, num_rays=8)
    params = init_params(
        lambda k: jmodel.init(k, j_rays_from_indices(dm.train_cameras, idx), key=jax.random.PRNGKey(0)), 21
    )
    res = jcfg.occ_grid_resolution
    binary = jnp.asarray(sphere_grid_binary(res))
    grid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res)
    grid = grid.replace(binary=binary, binary_rows=jocc._pack_rows(binary, res))
    jpipe = JPipeline(dm, jmodel, None, tx=build_optimizers(cfg.optimizers, params))

    def loss_and_grads(params, aux, key, anneal, update_proposals, field_bwd_levels, field_bwd_scale):
        """The loss and gradients of ``build_train_step``'s loss_fn."""
        k_pix, k_model = jax.random.split(key)
        idx, batch = dm.sample_train_batch(k_pix, dm.train_images)

        def loss_fn(p):
            rb = j_rays_from_indices(dm.train_cameras, idx)
            outputs = jmodel.apply(p, rb, key=k_model, anneal=anneal, update_proposals=update_proposals,
                                   field_bwd_levels=field_bwd_levels, field_bwd_scale=field_bwd_scale, model_aux=aux)
            metrics = jmodel.get_metrics_dict(outputs, batch, p)
            loss_dict = jmodel.get_loss_dict(outputs, batch, metrics, p, config=jmodel.config)
            return sum(loss_dict.values()), loss_dict

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    loss_and_grads = jax.jit(loss_and_grads, static_argnames=("update_proposals", "field_bwd_levels", "field_bwd_scale"))
    c2w = np.array(dm.train_cameras.camera_to_worlds)
    tcams = Cameras.create(c2w, HW * 1.2, HW * 1.2, HW / 2, HW / 2, HW, HW, device=CPU)
    tdm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=RAYS), tcams,
                                 torch.from_numpy(np.array(dm.train_images)), device=CPU)
    return dict(jmodel=jmodel, jcfg=jcfg, params=params, grid=grid, jpipe=jpipe, dm=dm, tdm=tdm,
                loss_and_grads=loss_and_grads)


def _flat_tables(params, log2_sizes):
    """Every hash-table level set to one value per feature (uniform in
    +-1): lane ``slot*8F + c*F + f`` holds feature f."""
    params = jax.tree_util.tree_map(np.copy, params)
    p = params["params"]
    rng = np.random.default_rng(22)
    for enc, log2_t in zip((p["field"]["mlp_base"]["encoding"], p["proposal_networks_0"]["mlp_base"]["encoding"]),
                           log2_sizes):
        L, S, _ = enc["hash_table"].shape
        F = 128 * S // 2**log2_t
        values = rng.uniform(-1, 1, (L, F)).astype(np.float32)
        enc["hash_table"] = np.ascontiguousarray(np.broadcast_to(np.tile(values, 128 // F)[:, None, :], (L, S, 128)))
    return params


def _run(world, start, tables):
    """Three steps (start, start+2, start+4) on both sides. Returns the
    per-step records and the final parameters of both."""
    jmodel, jcfg, jpipe, dm, tdm = (world[k] for k in ("jmodel", "jcfg", "jpipe", "dm", "tdm"))
    log2_sizes = (jcfg.log2_hashmap_size, jcfg.proposal_net_args_list[-1]["log2_hashmap_size"])
    params = world["params"] if tables == "live" else _flat_tables(world["params"], log2_sizes)
    jstate = jpipe.init_state(jax.random.PRNGKey(0), params=params).replace(aux=world["grid"])
    jhook = JNerfacto.make_aux_update_fn(jmodel, jcfg)

    model = torch_tiny_nerfacto(train=True)
    state_dict, grid, _ = train_state_from_jax(jstate, model)  # params and grid; the optimizer starts fresh
    model.load_state_dict(state_dict)
    tstate = TrainState(PerGroupAdam(nerfacto_optimizers(), model), step=start, aux=grid)
    tpipe = VanillaPipeline(tdm, model)
    thook = NerfactoModel.make_aux_update_fn(model, model.config)
    records = []
    for i, step in enumerate(range(start, start + 6, 2)):
        k_aux, k_step = jax.random.split(jax.random.PRNGKey(100 + i))
        jstate = jhook(jstate, step, k_aux)
        cells, jitter = jax_occupancy_draws(k_aux, jcfg.occ_grid_resolution, jcfg.occ_cells_per_update)
        thook(tstate, step, cells=cells, jitter=jitter)
        tstate.step = step
        kwargs = JNerfacto.step_kwargs(step, jcfg)
        assert NerfactoModel.step_kwargs(step, model.config) == kwargs
        rec = dict(step=step, kwargs=kwargs, grid=(np.asarray(jstate.aux.densities), np.asarray(jstate.aux.binary),
                                                    tstate.aux.densities.numpy(), tstate.aux.binary.numpy()))
        if i == 0:
            full = dict(update_proposals=True, field_bwd_levels=None, field_bwd_scale=1.0, anneal=1.0)
            (_, rec["j_terms"]), rec["j_grads"] = world["loss_and_grads"](jstate.params, jstate.aux, k_step,
                                                                          **{**full, **kwargs})
        hash_grid.reset_launch_counts()
        jstate, jmetrics = jpipe.train_step(jstate, dm.train_images, k_step, **kwargs)
        tmetrics = tpipe.train_step(tstate, draws=jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW), **kwargs)
        rec["launches"] = dict(hash_grid.launch_counts)
        rec["j_metrics"] = {k: float(v) for k, v in jmetrics.items()}
        rec["t_metrics"] = {k: float(v) for k, v in tmetrics.items()}
        if i == 0:
            rec["t_grads"] = {n: (None if p.grad is None else p.grad.clone()) for n, p in model.named_parameters()}
        records.append(rec)
    return records, jax.device_get(jstate.params), model


@pytest.fixture(scope="module", params=list(SCENARIOS))
def run(request, world):
    """Flat tables, at each point of the schedule."""
    return (request.param, "flat") + _run(world, SCENARIOS[request.param], "flat")


@pytest.fixture(scope="module")
def live_run(world):
    """Tables in +-1, from the early step."""
    return ("early", "live") + _run(world, SCENARIOS["early"], "live")


def test_schedule_and_occupancy_update(run):
    """The step kwargs are the reference's (asserted inside the run); the
    occupancy hook fired at both starts (304 and 6000 are multiples of 16)
    and gave the same grid: densities rtol 1e-4 (the field's density is an
    exp of a bf16 MLP output), the same binary cells on >= 99.9%."""
    name, tables, records, _, _ = run
    kw = records[0]["kwargs"]
    if name == "early":
        assert kw["update_proposals"] and "field_bwd_levels" not in kw
    else:
        assert not kw["update_proposals"] and kw["field_bwd_levels"] == (0, 2) and kw["field_bwd_scale"] == 2.0
    jd, jb, td, tb = records[0]["grid"]
    assert not np.array_equal(jb, sphere_grid_binary(round(len(jb) ** (1 / 3))))  # the update ran
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-6)
    assert (tb == jb).mean() >= 0.999


def _assert_losses(records, rtol_of, live):
    for i, rec in enumerate(records):
        j, t = rec["j_metrics"], rec["t_metrics"]
        assert np.isfinite(t["loss"])
        if live:
            ratio = t["interlevel_loss"] / j["interlevel_loss"]
            assert 1 / 3 <= ratio <= 3, (rec["step"], ratio)
        for k, r in rtol_of(i).items():
            np.testing.assert_allclose(t[k], j[k], rtol=r, atol=1e-7, err_msg=f"step {rec['step']} {k}")


def test_loss_matches_every_step(run):
    """Loss and its terms at each of the three steps, flat tables. The
    first step's forward does not depend on K1's rounding and every term
    agrees to 2e-3 relative (measured <= 1e-6). Adam's first step then moves
    each table entry that got a gradient by about the learning rate, so the
    tables are no longer flat and K1's redraws show: steps 2-3 hold the
    loss, rgb and distortion terms and PSNR to 2e-3 (measured <= 3e-4) and
    the interlevel term, a small difference of histograms, to 1e-1
    (measured 5.9%)."""

    def rtol_of(i):
        rtol = dict.fromkeys(("loss", "rgb_loss", "distortion_loss", "psnr", "camera_opt_regularizer"), 2e-3)
        rtol["interlevel_loss"] = 2e-3 if i == 0 else 1e-1
        return rtol

    _assert_losses(run[2], rtol_of, live=False)


def test_loss_gap_with_live_tables(live_run):
    """Tables in +-1, so K1's redrawn roundings change the forward: the
    loss, rgb term and PSNR within 1e-2 (measured 0.66%), distortion 5e-2
    (measured 2.2%), the camera-opt regularizer, 1e-5 in size, 1e-1
    (measured 6.2%), and the interlevel term, 0.2-0.5% of the loss, only
    within a factor of 3 (measured up to 1.85x): redrawn proposal roundings
    move the proposal histogram."""
    rtol = dict(loss=1e-2, rgb_loss=1e-2, psnr=1e-2, distortion_loss=5e-2, camera_opt_regularizer=1e-1)
    _assert_losses(live_run[2], lambda i: rtol, live=True)


def test_kernel_paths_per_step(run):
    """On the CPU every K1 call takes its twin: no launch is counted."""
    _, _, records, _, _ = run
    for rec in records:
        assert rec["launches"] == NO_HASH_LAUNCHES


def test_first_step_gradients(run):
    """The first step's gradients at identical parameters. Non-table
    parameters: within 5e-2 of each parameter's largest entry (bf16 MLP
    products rounded in another order; measured <= 2.0%). The tables: per
    level and feature, the sum over the table, within 1e-3 of the largest
    such sum (measured <= 1.1e-4); levels outside bwd_levels and a frozen
    proposal net get exactly nothing."""
    name, tables, records, _, model = run
    rec = records[0]
    jg = params_from_jax(rec["j_grads"], model)
    tg = rec["t_grads"]
    frozen = not rec["kwargs"]["update_proposals"]
    for n, ref in jg.items():
        ref = ref.numpy()
        got = tg[n]
        if frozen and n.startswith("proposal_networks"):
            assert (got is None or not got.any()) and not ref.any(), n  # Adam fills a missing gradient with zeros
            continue
        assert got is not None, n
        got = got.numpy()
        if n in TABLES:
            F = 128 * got.shape[1] // 2 ** (model.config.log2_hashmap_size if n.startswith("field")
                                             else model.config.proposal_net_args_list[-1]["log2_hashmap_size"])
            fsum = lambda x: x.reshape(x.shape[0], -1, F).sum(axis=1)  # lane % F is the feature
            gs, rs = fsum(got.astype(np.float64)), fsum(ref.astype(np.float64))
            peak = np.abs(rs).max()
            np.testing.assert_allclose(gs, rs, rtol=0, atol=1e-3 * peak, err_msg=n)
            levels = rec["kwargs"].get("field_bwd_levels")
            if n.startswith("field") and levels is not None:
                for l in range(got.shape[0]):
                    assert bool(got[l].any()) == (l in levels), (n, l)
            continue
        peak = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * peak + 1e-10, err_msg=n)


def test_parameters_after_three_adam_steps(run):
    """Parameters after three steps. Adam's first steps move every entry
    with a nonzero gradient by about the learning rate whatever the
    gradient's size, so an entry whose gradient is near zero amplifies the
    bf16 rounding differences: non-table parameters are held, in units of
    their group's learning rate, to a mean gap of 0.05 over all of them
    (measured 0.011), 0.1 per tensor (measured <= 0.046) and 2 per entry
    (measured 1.28). Tables are not compared entry by entry: their
    gradients land on the corners each side's rounding picked."""
    name, tables, records, jparams, model = run
    jp = params_from_jax(jparams, model)
    gaps = []
    for n, p in model.named_parameters():
        if n in TABLES:
            continue
        lr = 6e-4 if n.startswith("camera_optimizer") else 1e-2
        gap = np.abs(p.detach().numpy() - jp[n].numpy()) / lr
        assert gap.max() <= 2.0 and gap.mean() <= 0.1, (n, gap.max(), gap.mean())
        gaps.append(gap.ravel())
    assert np.concatenate(gaps).mean() <= 0.05
