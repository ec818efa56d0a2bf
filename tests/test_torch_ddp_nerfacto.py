"""The port's data-parallel layer (``nerfstudio_torch/parallel/mesh.py``)
on the CPU, with 2 gloo ranks in processes of their own
(``_torch_ddp.run_ranks``): the collectives at world sizes 1 and 2; one
nerfacto step at 2 ranks against JAX's mesh step on the 8-device CPU mesh
(``build_pipeline(config, use_mesh=True)``) with JAX's draws handed in,
and against the port's own step at 1 rank on the same global draws;
instant-ngp's occupancy refresh and steps at 2 ranks against 1; the
replicas bit-equal after steps across occupancy refreshes; the training
CLI on 2 ranks (rank 0 alone writes, a resume bit-equal to a continued
run, two one-device "machines" equal to one two-device machine, ``cuda``
without the cards refused)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)
import _torch_ddp as ddp
from _torch_port import NUM_IMAGES, TINY_MODEL, jax_occupancy_draws, jax_step_draws
from fixtures import make_blender_fixture, make_nerfstudio_fixture
from test_torch_instant_ngp import jax_float32_mlps
from test_torch_train_step import _flat_tables
from test_torch_trainer import RAYS, TINY_RUN, _assert_same, _config
from nerfstudio_torch.engine import trainer as ttrainer
from nerfstudio_torch.parallel import mesh
from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

HW = 16
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_nerfstudio_fixture(tmp_path_factory.mktemp("scene") / "ns", n=NUM_IMAGES + 1, hw=HW)


# --------------------------------------------------------------------------
# (a) the collectives


def test_collectives_at_world_size_two(tmp_path):
    """Two ranks: a gradient present on both is averaged, one present on
    rank 0 alone averaged with zeros (and present on both after), one on
    neither stays None, a float64 one takes its own buffer; ``shard_rays``
    gives each rank its contiguous half of every tensor of a tree;
    ``rand_rays`` inside ``ray_shard`` returns the rank's rows of the
    global draw and consumes the generator as the global draw does."""
    ranks = ddp.run_ranks(ddp.collectives, (), 2, tmp_path)
    full = torch.rand((8, 1), generator=torch.Generator().manual_seed(3))
    after = _after_draw(8)
    for r, res in enumerate(ranks):
        g = res["grads"]
        assert torch.equal(g[0], torch.arange(6.0).view(3, 2) * 1.5)
        assert torch.equal(g[1], torch.ones(4))
        assert g[2] is None
        assert g[3].dtype == torch.float64 and torch.equal(g[3], torch.tensor([1.5, 3.0, 4.5], dtype=torch.float64))
        assert torch.equal(res["shard"]["image"], torch.arange(16.0).view(8, 2)[4 * r:4 * r + 4])
        assert torch.equal(res["shard"]["parts"][0], torch.arange(8)[4 * r:4 * r + 4])
        assert res["shard"]["parts"][1] is None
        assert torch.equal(res["sharded"], full[4 * r:4 * r + 4])
        assert torch.equal(res["plain"], after)
        assert torch.equal(res["summed"], torch.tensor([2.0, 1.0])) and torch.equal(res["peak"][:1], torch.ones(1))
        assert float(res["means"]["a"]) == 0.5 and float(res["means"]["b"]) == 2.0 and res["world"] == 2


def _after_draw(n):
    """The 4 uniforms a generator seeded with 3 gives after ``n``."""
    g = torch.Generator().manual_seed(3)
    torch.rand((n, 1), generator=g)
    return torch.rand((4, 1), generator=g)


def test_collectives_at_world_size_one(tmp_path):
    """One rank, no process group: every gradient, shard and draw as it
    is (``rand_rays`` inside ``ray_shard`` is ``torch.rand``)."""
    res = ddp.run_ranks(ddp.collectives, (), 1, tmp_path)[0]
    assert not mesh.is_initialized() and res["world"] == 1
    g = res["grads"]
    assert torch.equal(g[0], torch.arange(6.0).view(3, 2)) and torch.equal(g[1], torch.full((4,), 2.0))
    assert g[2] is None and torch.equal(g[3], torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    assert torch.equal(res["shard"]["image"], torch.arange(16.0).view(8, 2))
    assert torch.equal(res["sharded"], torch.rand((4, 1), generator=torch.Generator().manual_seed(3)))
    assert torch.equal(res["summed"], torch.tensor([1.0, 0.0])) and float(res["means"]["a"]) == 0.0


def test_shard_rays_refuses_an_uneven_batch():
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.shard_rays(torch.zeros(6, 3), world=4, r=0)
    assert torch.equal(mesh.shard_rays(torch.arange(6), world=3, r=2), torch.tensor([4, 5]))


# --------------------------------------------------------------------------
# (b) one nerfacto step against JAX's mesh step


@pytest.fixture(scope="module")
def mesh_pair(scene):
    """JAX's factory-built nerfacto on its 8-device CPU mesh and the port's
    on the CPU, the tiny model with flat tables (test_torch_train_step's
    trick), on the scene."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.pipelines.factory import build_pipeline

    jconfig = jget_method("nerfacto")
    jconfig.model = dataclasses.replace(jconfig.model, **TINY_MODEL)
    jconfig.data = scene
    jconfig.dataparser.eval_mode, jconfig.dataparser.eval_interval = "interval", NUM_IMAGES + 1
    jconfig.datamanager.train_num_rays_per_batch = RAYS
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=True)
    assert jpipe.mesh is not None and jpipe.mesh.size == 8
    m = jconfig.model
    params = _flat_tables(jax.device_get(jstate.params),
                          (m.log2_hashmap_size, m.proposal_net_args_list[-1]["log2_hashmap_size"]))
    host_state = jax.device_get(jstate.replace(params=params))
    config = _config("nerfacto", scene, Path("unused"), 1, **TINY_MODEL)
    pipe, state, _ = build_pipeline(config)
    return jpipe, host_state, jconfig, pipe, state, config


def _group_names(optimizer, model):
    """{group: [parameter name in the group's state order]}."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return {g: [name_of[id(p)] for pg in opt.param_groups for p in pg["params"]]
            for g, opt in optimizer.optimizers.items()}


@pytest.mark.parametrize("step", [304, 6000], ids=["early", "steady"])
def test_two_rank_step_matches_jax_mesh_step(mesh_pair, tmp_path, step):
    """The occupancy hook and one step at ``step`` with JAX's draws, the
    MLPs in float32 on both sides; 2 ranks against JAX's 8-device mesh
    step. The ceilings are test_torch_trainer's for one step, the
    measured gaps in brackets. The loss and every term within 2e-3
    relative (<= 1.4e-7; the interlevel term, ~4e-7 with flat tables,
    1.9e-11 absolute). The Adam first moments (0.1 x the step's gradient,
    JAX's read from its optax state): each non-table array within 5e-2 of
    its peak (2.2e-5), each table's summed per level and feature within
    1e-3 of the largest sum (4.9e-4), the proposal's 1e-2 (5.7e-4); a
    frozen proposal net's (steady) zero on both. The parameters after
    Adam, tables aside, in units of their group's rate: 2 per entry, 0.1
    mean per array, 0.05 overall, as test_parameters_after_three_adam_steps
    (7.5e-6 per entry). The grid after the hook: densities 1e-4, binary
    cells on 99.9%. Then the port at 1 rank on the same global draws: loss
    and terms 1e-5 relative, every gradient within 1e-5 of its array's
    peak (3.9e-7), the parameters after Adam within 1e-5 of a learning
    rate (1.5e-6). The two ranks' parameters, moments and grid bit-equal."""
    from nerfstudio_tpu.models.nerfacto import NerfactoModel as JNerfacto

    jpipe, host_state, jconfig, pipe, pstate, config = mesh_pair
    payload = trainer_checkpoint_from_jax(host_state, pipe.model, pstate.optimizer)
    k_aux, k_step = jax.random.split(jax.random.PRNGKey(7))
    jstate = jax.tree_util.tree_map(jax.numpy.asarray, host_state).replace(step=jax.numpy.asarray(step, jax.numpy.int32))
    kwargs = JNerfacto.step_kwargs(step, jconfig.model)
    with jax_float32_mlps():
        jstate = jpipe.aux_update_fn(jstate, step, k_aux)
        jgrid = jax.device_get(jstate.aux)  # the step donates its state
        jpipe._train_step = None  # traced here, with the MLPs in float32
        jafter, jmetrics = jpipe.train_step(jstate, jpipe.datamanager.train_images, k_step, **kwargs)
        jpipe._train_step = None
    cells, jitter = jax_occupancy_draws(k_aux, jconfig.model.occ_grid_resolution, jconfig.model.occ_cells_per_update)
    draws = jax_step_draws(k_step, RAYS, NUM_IMAGES, HW, HW)
    args = (config, payload, step, cells, jitter, draws, kwargs)
    two = ddp.run_ranks(ddp.nerfacto_step, args, 2, tmp_path)
    one = ddp.run_ranks(ddp.nerfacto_step, args, 1, tmp_path)[0]
    a, b = two
    for key in ("params", "densities", "binary", "optimizer"):
        _assert_same(a[key], b[key], key)  # the replicas bit-equal
    np.testing.assert_allclose(a["densities"].numpy(), np.asarray(jgrid.densities), rtol=1e-4, atol=1e-6)
    assert (a["binary"].numpy() == np.asarray(jgrid.binary)).mean() >= 0.999
    for k in ("loss", "rgb_loss", "distortion_loss", "interlevel_loss", "psnr"):
        np.testing.assert_allclose(a["metrics"][k], float(jmetrics[k]), rtol=2e-3, atol=1e-7, err_msg=k)

    jpay = trainer_checkpoint_from_jax(jax.device_get(jafter), pipe.model, pstate.optimizer)
    frozen = not kwargs["update_proposals"]
    log2 = {"field": config.model.log2_hashmap_size,
            "proposal_networks": config.model.proposal_net_args_list[-1]["log2_hashmap_size"]}
    for group, names in _group_names(pstate.optimizer, pipe.model).items():
        got_state = a["optimizer"]["optimizers"][group]["state"]
        want_state = jpay["optimizer"]["optimizers"][group]["state"]
        for i, n in enumerate(names):
            got, want = (s[i]["exp_avg"].numpy().astype(np.float64) for s in (got_state, want_state))
            if frozen and group == "proposal_networks":
                assert not got.any() and not want.any(), n
                continue
            if n.endswith("hash_table"):
                F = 128 * got.shape[1] // 2 ** log2[group]
                got, want = (x.reshape(x.shape[0], -1, F).sum(axis=1) for x in (got, want))
                rel = 1e-2 if group == "proposal_networks" else 1e-3
                np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-12, err_msg=n)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max() + 1e-10, err_msg=n)
    gaps = []
    for n, (value, _) in a["params"].items():
        if n.endswith("hash_table"):
            continue
        lr = 6e-4 if n.startswith("camera_optimizer") else 1e-2
        gap = np.abs(value.numpy() - jpay["model"][n].numpy()) / lr
        assert gap.max() <= 2.0 and gap.mean() <= 0.1, (n, gap.max(), gap.mean())
        gaps.append(gap.ravel())
    assert np.concatenate(gaps).mean() <= 0.05

    for k in ("loss", "rgb_loss", "distortion_loss", "interlevel_loss", "psnr"):
        np.testing.assert_allclose(a["metrics"][k], one["metrics"][k], rtol=1e-5, atol=1e-9, err_msg=k)
    for n, (value, grad) in one["params"].items():
        v2, g2 = a["params"][n]
        assert (grad is None) == (g2 is None), n
        if grad is not None:
            peak = float(grad.abs().max())
            assert float((g2 - grad).abs().max()) <= 1e-5 * peak, (n, float((g2 - grad).abs().max()) / peak)
        lr = 6e-4 if n.startswith("camera_optimizer") else 1e-2
        assert float((v2 - value).abs().max()) <= 1e-5 * lr, (n, float((v2 - value).abs().max()) / lr)


# --------------------------------------------------------------------------
# (c) instant-ngp's occupancy refresh at 2 ranks against 1


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender_ddp"), hw=16)


def test_instant_ngp_refresh_and_steps_two_ranks_equal_one(blender, tmp_path):
    """instant-ngp (random background, the occupancy sampler) for 4
    trainer iterations with a refresh at steps 2 and 3 (warm-up 2, every
    step), on 2 ranks and on 1 from the same seed, the MLPs in float32:
    the grid's densities within 1e-5 relative + 1e-6 (as JAX's
    test_ngp_mesh_aux_matches_single_device holds its mesh; measured
    1.1e-7 relative), its cells on 99.9% (all), each step's loss within
    1e-5 relative (8.7e-8); the two ranks' states bit-equal. (The gradients of 2 ranks and of 1 differ in summation
    order; with bfloat16 MLPs the last-bit parameter gaps that leaves
    cross bfloat16 roundings in the refresh, ~2e-3 relative on ~5% of the
    cells.)"""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig

    config = get_method("instant-ngp")
    config.data, config.dataparser = blender, BlenderDataParserConfig(data=blender)
    config.machine.device_type = "cpu"
    config.trainer.output_dir, config.trainer.vis = tmp_path / "out", "none"
    config.datamanager.train_num_rays_per_batch = 32
    for k, v in dict(log2_hashmap_size=9, num_levels=4, max_res=64, grid_resolution=16, num_coarse_probes=16,
                     num_samples_per_ray=8, grid_warmup_steps=2, grid_update_every=1,
                     eval_num_rays_per_chunk=64).items():
        setattr(config.model, k, v)
    a, b = ddp.run_ranks(ddp.trainer_steps, (config, 4), 2, tmp_path)
    one = ddp.run_ranks(ddp.trainer_steps, (config, 4), 1, tmp_path)[0]
    _assert_same(a["payload"], b["payload"])
    got, want = a["payload"]["aux"], one["payload"]["aux"]
    assert not torch.equal(want["densities"], torch.zeros_like(want["densities"]))  # the refresh ran
    np.testing.assert_allclose(got["densities"].numpy(), want["densities"].numpy(), rtol=1e-5, atol=1e-6)
    assert (got["binary"] == want["binary"]).float().mean() >= 0.999
    for m2, m1 in zip(a["metrics"], one["metrics"]):
        np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)


# --------------------------------------------------------------------------
# (e) replicas bit-equal across occupancy refreshes, the trainer's cadences


def test_replicas_stay_bit_equal_through_refreshes_evals_and_saves(scene, tmp_path):
    """``Trainer.train`` of the tiny nerfacto on 2 ranks for 6 steps
    (occupancy updates from step 2 every 2; eval batch and eval image at
    steps 3; a save at 4 and at the end): every parameter, Adam moment and
    count, the grid, the step and the generator's state equal bit for bit
    on both ranks; rank 0 alone wrote the checkpoints and the events (each
    logged step once)."""
    config = _config("nerfacto", scene, tmp_path / "out", 6, **TINY_RUN)
    config.trainer.steps_per_save, config.trainer.save_only_latest_checkpoint = 4, False
    config.trainer.steps_per_eval_batch = config.trainer.steps_per_eval_image = 3
    a, b = ddp.run_ranks(ddp.trainer_run, (config,), 2, tmp_path)
    _assert_same(a["payload"], b["payload"])
    assert a["payload"]["step"] == 6 and a["payload"]["optimizer"]["count"] == 6
    assert not torch.equal(a["payload"]["aux"]["densities"], torch.zeros_like(a["payload"]["aux"]["densities"]))
    run = tmp_path / "out" / "run" / "nerfacto" / "t"
    assert ttrainer.checkpoint_steps(run / "nerfstudio_models") == [4, 6]
    _assert_same(ttrainer.read_checkpoint(run / "nerfstudio_models", 6)[1], a["payload"])
    prefixes = [json.loads(line)["prefix"] for line in (run / "scalars.jsonl").read_text().splitlines()]
    assert prefixes.count("train") == 2 and prefixes.count("eval_batch") == 1 and prefixes.count("eval") == 1


# --------------------------------------------------------------------------
# (f) the training CLI on 2 ranks


def _cli(scene, out, steps, extra=()):
    return ["nerfacto", "--data", str(scene), "--machine.device-type", "cpu", "--trainer.output-dir", str(out),
            "--trainer.experiment-name", "run", "--trainer.timestamp", "t", "--trainer.vis", "none",
            "--trainer.max-num-iterations", str(steps), "--trainer.steps-per-eval-batch", "0",
            "--trainer.steps-per-eval-image", "0", "--trainer.steps-per-eval-all-images", "0",
            "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", str(NUM_IMAGES + 1),
            "--datamanager.train-num-rays-per-batch", str(RAYS),
            *[x for k, v in TINY_RUN.items() if not isinstance(v, (tuple, list)) and k != "proposal_net_args_list"
              for x in (f"--model.{k}", str(v))], *extra]


def _payload(out, steps):
    return ttrainer.read_checkpoint(Path(out) / "run" / "nerfacto" / "t" / "nerfstudio_models", steps)[1]


def test_cli_two_ranks_resume_and_two_machines(scene, tmp_path):
    """``scripts.train nerfacto --machine.device-type cpu --machine.num-devices
    2`` for 2N steps with a save at N, and a resume from that save to 2N:
    the two step-2N checkpoints equal bit for bit (the model, every moment
    and count, the grid, the generator); rank 0 alone wrote ``config.yml``
    and the checkpoints. Two one-device "machines" on
    localhost (``--machine.num-machines 2 --machine.machine-rank {0,1}
    --machine.dist-url tcp://127.0.0.1:PORT``, two processes) end bit-equal
    to the two-device run."""
    from nerfstudio_torch.scripts import train

    n = 3
    two = ["--machine.num-devices", "2"]
    run = tmp_path / "straight" / "run" / "nerfacto" / "t"
    train.main(_cli(scene, tmp_path / "straight", 2 * n, two + ["--trainer.steps-per-save", str(n),
                                                               "--trainer.save-only-latest-checkpoint", "False"]))
    train.main(_cli(scene, tmp_path / "resumed", 2 * n, two + ["--trainer.load-dir", str(run / "nerfstudio_models"),
                                                              "--trainer.load-step", str(n)]))
    straight = _payload(tmp_path / "straight", 2 * n)
    assert straight["step"] == 2 * n and straight["optimizer"]["count"] == 2 * n
    _assert_same(straight, _payload(tmp_path / "resumed", 2 * n))
    assert sorted(p.name for p in run.iterdir()) == ["config.pkl", "config.yml", "nerfstudio_models", "scalars.jsonl"]
    assert ttrainer.checkpoint_steps(run / "nerfstudio_models") == [n, 2 * n]
    logged = [json.loads(line)["step"] for line in (run / "scalars.jsonl").read_text().splitlines()]
    assert logged == [0, 2 * n - 1]  # written once, by rank 0

    port = mesh.free_port()
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // 2)),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-m", "nerfstudio_torch.scripts.train",
                               *_cli(scene, tmp_path / "machines", 2 * n,
                                     ["--machine.num-devices", "1", "--machine.num-machines", "2",
                                      "--machine.machine-rank", str(r), "--machine.dist-url",
                                      f"tcp://127.0.0.1:{port}"])], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    _assert_same(straight, _payload(tmp_path / "machines", 2 * n))


def test_cli_refuses_cards_it_does_not_have(scene, tmp_path):
    """``--machine.num-devices`` above the machine's CUDA devices raises
    before any rank starts: nothing falls back to the CPU or to one rank."""
    from nerfstudio_torch.scripts import train

    argv = [a for a in _cli(scene, tmp_path, 2) if a not in ("--machine.device-type", "cpu")]
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"asks for {n} CUDA devices and this machine has"):
        train.main(argv + ["--machine.num-devices", str(n)])
    assert not (tmp_path / "run").exists()
