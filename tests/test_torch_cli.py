"""The port's CLI: ``apply_overrides`` against JAX's on the same argv; the
train script trains, saves, resumes and evaluates on the CPU (depth-nerfacto,
semantic-nerfw and phototourism through ``--dataparser nerfstudio-data``);
the gate runner writes the keys of ``benchmarks/gate_nerfacto.json`` and
routes each method to its scene and JAX record; the method registry names
the unported methods and parsers; without a card the default device
raises."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from _torch_port import make_synthetic_scene
from fixtures import make_nerfstudio_fixture
from nerfstudio_tpu.configs.cli import apply_overrides as japply_overrides
from nerfstudio_tpu.configs.method_configs import get_method as jget_method
from nerfstudio_torch.configs.cli import apply_overrides, describe
from nerfstudio_torch.configs.method_configs import NOT_PORTED, get_method
from nerfstudio_torch.scripts import eval as teval
from nerfstudio_torch.scripts import gate, train

REPO = Path(__file__).resolve().parent.parent

ARGV = {
    "nerfacto": ["--trainer.max_num_iterations", "123", "--trainer.load_dir", "a/b", "--trainer.load-step=7",
                 "--trainer.save_only_latest_checkpoint", "false", "--model.num-levels", "6",
                 "--model.num_proposal_samples_per_ray", "128,32", "--model.background_color", "white",
                 "--model.use_appearance_embedding", "0", "--datamanager.train_num_rays_per_batch=512",
                 "--dataparser.eval_mode", "interval", "--dataparser.downscale_factor", "none",
                 "--data", "scene", "--seed", "5", "leftover"],
    "splatfacto": ["--model.sh_degree", "2", "--model.rasterize_mode", "antialiased", "--model.max_gaussians",
                   "1000", "--dataparser.load_3D_points", "false", "--trainer.steps_per_save", "10"],
    "splatfacto-big": ["--model.densify_grad_thresh", "0.001", "--trainer.max_num_iterations", "8000"],
    "splatfacto-mcmc": ["--model.mcmc_noise_lr", "1e5", "--model.use_bilateral_grid", "true",
                        "--model.camera_optimizer_mode", "SO3xR3", "--model.use_scale_regularization", "1"],
    "neus-facto": ["--model.num_neus_samples_per_ray", "24", "--model.eikonal_loss_mult", "0.5",
                   "--trainer.vis", "none", "--datamanager.eval_num_rays_per_batch", "64"],
    "depth-nerfacto": ["--model.depth_loss_type", "urf", "--model.depth_sigma", "0.02",
                       "--dataparser.depth_unit_scale_factor", "0.01", "--model.field_bwd_level_period", "0"],
}


def _leaves(obj, prefix=""):
    """{dotted name: value} of a config's plain fields (its optimizers and
    ``_target`` aside)."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.name.startswith("_") or f.name == "optimizers":
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


@pytest.mark.parametrize("method", sorted(ARGV))
def test_apply_overrides_matches_jax(method):
    """The same argv on both packages' method configs: the same leftovers,
    every field the two share equal, and the trainer, datamanager and
    dataparser with exactly JAX's fields (the port's config adds
    ``machine``); the optimizer groups' rates, eps and schedules equal."""
    jcfg, tcfg = jget_method(method), get_method(method)
    assert japply_overrides(jcfg, list(ARGV[method])) == apply_overrides(tcfg, list(ARGV[method]))
    j, t = _leaves(jcfg), _leaves(tcfg)
    shared = set(j) & set(t)
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}
    for part in ("trainer.", "datamanager.", "dataparser."):
        assert {k for k in t if k.startswith(part)} == {k for k in j if k.startswith(part)}, part
    assert set(t) - set(j) <= {k for k in t if k.startswith(("machine.", "model."))}
    assert len({k for k in shared if k.startswith("model.")}) >= 20
    assert set(tcfg.optimizers) == set(jcfg.optimizers)
    for g, jo in jcfg.optimizers.items():
        to = tcfg.optimizers[g]
        assert (to["optimizer"].lr, to["optimizer"].eps) == (jo["optimizer"].lr, jo["optimizer"].eps), g
        js, ts = jo["scheduler"], to["scheduler"]
        assert type(ts).__name__ == type(js).__name__, g
        for f in dataclasses.fields(ts):
            assert getattr(ts, f.name) == getattr(js, f.name), (g, f.name)
    assert any("--machine.device-type" in line for line in describe(tcfg))


def test_unported_methods_name_their_roadmap_item():
    for name, item in NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
            get_method(name)
    with pytest.raises(SystemExit):
        get_method("no-such-method")


def test_machine_seed_is_refused(tmp_path):
    """The seed is the method config's ``--seed``: the port has no
    ``machine.seed`` to ignore, so the flag is refused."""
    with pytest.raises(SystemExit, match="unknown config field: machine.seed"):
        apply_overrides(get_method("nerfacto"), ["--seed", "4", "--machine.seed", "3"])
    with pytest.raises(SystemExit, match="unknown config field: machine.seed"):
        train.main(["nerfacto", "--data", str(tmp_path), "--machine.seed", "3"])


TINY = ["--datamanager.train_num_rays_per_batch", "64", "--model.log2_hashmap_size", "12", "--model.max_res", "64",
        "--model.occ_grid_resolution", "16", "--model.hidden_dim", "16", "--model.hidden_dim_color", "16",
        "--model.num_nerf_samples_per_ray", "8", "--model.eval_num_rays_per_chunk", "512"]


def test_train_script_trains_saves_resumes_and_evaluates(tmp_path, capsys):
    """8 steps on the CPU with a save at 4, a resume from that run's
    checkpoints to 12, then ``scripts/eval.py`` on the resumed run."""
    scene = make_nerfstudio_fixture(tmp_path / "scene", n=5, hw=16)
    common = ["nerfacto", "--data", str(scene), "--machine.device_type", "cpu", "--trainer.output_dir",
              str(tmp_path / "out"), "--trainer.vis", "none", "--trainer.steps_per_save", "4",
              "--trainer.steps_per_eval_image", "6", "--trainer.steps_per_eval_batch", "5", *TINY]
    train.main(common + ["--trainer.max_num_iterations", "8", "--trainer.timestamp", "run1"])
    run1 = tmp_path / "out" / "scene" / "nerfacto" / "run1"
    assert json.loads((run1 / "config.yml").read_text())["machine"]["device_type"] == "cpu"
    train.main(common + ["--trainer.max_num_iterations", "12", "--trainer.timestamp", "run2",
                         "--trainer.load_dir", str(run1 / "nerfstudio_models")])
    out = capsys.readouterr().out
    assert "loaded checkpoint at step 8" in out and "[eval 6]" in out and "[eval_batch 5]" in out
    run2 = tmp_path / "out" / "scene" / "nerfacto" / "run2"
    assert sorted(p.name for p in (run2 / "nerfstudio_models").iterdir()) == ["step-000000012.ckpt"]
    info = teval.main([str(run2), "--output-path", str(tmp_path / "eval.json")])
    assert info["step"] == 12 and json.loads((tmp_path / "eval.json").read_text())["results"] == info["results"]
    assert {"psnr", "ssim", "num_rays_per_sec", "fps", "psnr_std"} <= set(info["results"])


def test_train_script_splatfacto_resumes(tmp_path, capsys):
    scene = make_nerfstudio_fixture(tmp_path / "scene", n=5, hw=16)
    common = ["splatfacto", "--data", str(scene), "--machine.device_type", "cpu", "--trainer.output_dir",
              str(tmp_path / "out"), "--trainer.vis", "none", "--trainer.steps_per_save", "3",
              "--model.max_gaussians", "300", "--model.num_random", "100", "--model.random_init", "true"]
    train.main(common + ["--trainer.max_num_iterations", "3", "--trainer.timestamp", "run1"])
    ckpt = tmp_path / "out" / "scene" / "splatfacto" / "run1" / "nerfstudio_models"
    train.main(common + ["--trainer.max_num_iterations", "5", "--trainer.timestamp", "run2",
                         "--trainer.load_dir", str(ckpt)])
    assert "loaded splat checkpoint at step 3" in capsys.readouterr().out


def test_gate_runner_writes_the_gate_record_keys(tmp_path):
    """nerfacto at its shipped config for 4 steps on the small synthetic
    scene, on the CPU: every key of the JAX gate record (and of its
    metrics), the card's name and power limit, and the launches."""
    scene = make_synthetic_scene(tmp_path / "synthetic")
    out = tmp_path / "gate.json"
    gate.main(["nerfacto", str(scene), str(out), "--steps", "4", "--machine.device_type", "cpu"])
    got = json.loads(out.read_text())
    want = json.loads((REPO / "benchmarks" / "gate_nerfacto.json").read_text())
    assert set(want) <= set(got) and set(want["metrics"]) == set(got["metrics"])
    assert got["steps"] == 4 and got["shipped_defaults"] and got["device"] == "cpu" and "power_limit" in got
    assert got["gates"] == want["gates"] and set(got["launches"]) == {"train", "eval"}


@pytest.mark.parametrize("method", ["nerfacto", "splatfacto"])
@pytest.mark.parametrize("scene", ["basic", "distorted", "masked"])
def test_gate_record_of_each_scene(method, scene):
    """The JAX record the gate runner sets beside its result: the scene's
    own file (``basic`` without a suffix), PSNR and SSIM only; none for a
    scene without a record."""
    want = json.loads((REPO / "benchmarks" / f"gate_{method}{'' if scene == 'basic' else '_' + scene}.json")
                      .read_text())["metrics"]
    assert gate.jax_record(method, scene) == {"psnr": want["psnr"], "ssim": want["ssim"]}
    assert gate.jax_record(method, "synthetic") is None


@pytest.mark.parametrize("method", ["splatfacto-big", "splatfacto-mcmc"])
def test_gate_record_of_the_big_and_mcmc_methods(method):
    """The methods' records are named with underscores; both run 8000 steps."""
    want = json.loads((REPO / "benchmarks" / f"gate_{method.replace('-', '_')}.json").read_text())
    assert gate.jax_record(method, "basic") == {"psnr": want["metrics"]["psnr"], "ssim": want["metrics"]["ssim"]}
    assert gate.GATE_STEPS[method] == want["steps"] == 8000


@pytest.mark.parametrize("method", ["splatfacto-big", "splatfacto-mcmc"])
def test_train_script_trains_the_big_and_mcmc_methods(method, tmp_path, capsys):
    """Each method at its shipped config but for the slots, on the CPU:
    trains past a refine (warm-up cut to 2 steps, refine every 2), saves,
    resumes from the save."""
    scene = make_nerfstudio_fixture(tmp_path / "scene", n=5, hw=16)
    common = [method, "--data", str(scene), "--machine.device_type", "cpu", "--trainer.output_dir",
              str(tmp_path / "out"), "--trainer.vis", "none", "--trainer.steps_per_save", "4",
              "--model.max_gaussians", "300", "--model.num_random", "100", "--model.random_init", "true",
              "--model.max_refine_new", "32", "--model.warmup_length", "2", "--model.refine_every", "2"]
    train.main(common + ["--trainer.max_num_iterations", "4", "--trainer.timestamp", "run1"])
    ckpt = tmp_path / "out" / "scene" / method / "run1" / "nerfstudio_models"
    train.main(common + ["--trainer.max_num_iterations", "6", "--trainer.timestamp", "run2",
                         "--trainer.load_dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "loaded splat checkpoint at step 4" in out and "eval:" in out


def test_default_device_without_a_card_raises(tmp_path, monkeypatch):
    """The shipped ``machine.device_type`` is cuda: without a card the
    factory and the train script raise instead of running on the CPU."""
    from nerfstudio_torch.pipelines.factory import build_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = make_nerfstudio_fixture(tmp_path / "scene", n=3, hw=8)
    config = get_method("nerfacto")
    config.data = scene
    assert config.machine.device_type == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_pipeline(config)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train.main(["splatfacto", "--data", str(scene), "--trainer.output_dir", str(tmp_path / "out")])


@pytest.fixture(scope="module")
def tool_scenes(tmp_path_factory):
    """The synthetic tool's basic, semantic and appearance scenes side by
    side at 32^2 (8 train, 2 test frames, 500 seed points)."""
    import subprocess
    import sys

    root = tmp_path_factory.mktemp("tool_scenes")
    for scene in ("basic", "semantic", "appearance"):
        subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"), str(root / scene), "--hw",
                        "32", "--n-train", "8", "--n-test", "2", "--n-points", "500", "--scene", scene], check=True,
                       capture_output=True, timeout=300)
    return root


@pytest.mark.parametrize("method, scene", [("depth-nerfacto", "basic"), ("semantic-nerfw", "semantic"),
                                           ("phototourism", "appearance")])
def test_train_script_trains_and_evaluates_the_nerfacto_family(method, scene, tool_scenes, tmp_path, capsys):
    """Two steps on the CPU through ``scripts/train.py --dataparser
    nerfstudio-data`` with the method's own loss term logged, then
    ``scripts/eval.py`` on the run. ``--dataparser`` sets a fresh parser
    config, as JAX's train script does, so depth-nerfacto asks for the
    seed points of its SfM depth again."""
    points = ["--dataparser.load_3D_points", "true"] if method == "depth-nerfacto" else []
    train.main([method, "--data", str(tool_scenes / scene), "--dataparser", "nerfstudio-data", *points,
                "--machine.device_type", "cpu", "--trainer.output_dir", str(tmp_path / "out"), "--trainer.vis", "none",
                "--trainer.max_num_iterations", "2", "--trainer.timestamp", "run", *TINY])
    out = capsys.readouterr().out
    term = {"depth-nerfacto": "depth_loss=", "semantic-nerfw": "semantics_loss=", "phototourism": "rgb_loss="}[method]
    assert "[train 0]" in out and term in out
    run = tmp_path / "out" / scene / method / "run"
    info = teval.main([str(run), "--output-path", str(tmp_path / "eval.json")])
    assert info["step"] == 2 and {"psnr", "ssim"} <= set(info["results"])


@pytest.mark.parametrize("method", ["semantic-nerfw", "phototourism"])
def test_the_shipped_parser_names_its_roadmap_item(method, tool_scenes, tmp_path):
    """Without ``--dataparser`` the method reads the capture with its own
    parser, as the reference's does (sitcoms3d's ``cameras.json``,
    phototourism's COLMAP model under ``dense/sparse``), no longer refused:
    on a nerfstudio capture it finds neither and says which file it
    looked for."""
    missing = {"semantic-nerfw": "cameras.json", "phototourism": "dense/sparse"}[method]
    with pytest.raises(FileNotFoundError, match=missing):
        train.main([method, "--data", str(tool_scenes / "basic"), "--machine.device_type", "cpu",
                    "--trainer.output_dir", str(tmp_path / "out"), "--trainer.vis", "none", *TINY])


@pytest.mark.parametrize("method, scene", [("depth-nerfacto", "basic"), ("semantic-nerfw", "semantic"),
                                           ("phototourism", "appearance")])
def test_gate_runner_routes_the_nerfacto_family(method, scene, tool_scenes, tmp_path):
    """Given the basic scene, semantic-nerfw trains on the semantic scene
    beside it and phototourism on the appearance one (the JAX runner's
    routes); depth-nerfacto loads the seed points for its SfM depth. The
    JAX record set beside each cell is the cell's own file, at the gate's
    5000 steps."""
    result, run = gate.run_gate(method, tool_scenes / "basic", tmp_path, steps=2,
                                overrides=["--machine.device_type", "cpu", *TINY])
    assert result["scene"] == scene and result["steps"] == 2
    want = json.loads((REPO / "benchmarks" / f"gate_{method.replace('-', '_')}"
                       f"{'' if scene == 'basic' else '_' + scene}.json").read_text())
    assert result["jax_record"] == {"psnr": want["metrics"]["psnr"], "ssim": want["metrics"]["ssim"]}
    assert gate.GATE_STEPS[method] == want["steps"] == 5000
    dataset = run["pipeline"].datamanager.train_dataset
    assert type(dataset).__name__ == {"depth-nerfacto": "DepthDataset", "semantic-nerfw": "SemanticDataset",
                                      "phototourism": "InputDataset"}[method]
    if method == "depth-nerfacto":
        assert dataset.provides_depth and dataset._sfm_points is not None
    if method == "semantic-nerfw":
        assert run["pipeline"].model.config.num_semantic_classes == len(dataset.semantics.classes) == 6
