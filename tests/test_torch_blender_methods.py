"""The Blender-protocol methods through the user's entry points on the CPU,
on a tiny RGBA ``blender`` scene of ``tools/make_synthetic_dataset.py``:
``scripts/train.py nerfacto --dataparser blender-data`` trains and
evaluates over white (the eval background override; it raised before);
``scripts/train.py``, ``scripts/eval.py`` and ``scripts/gate.py`` run
tensorf, vanilla-nerf, mipnerf and dnerf (on the tool's time-varying
``dnerf`` scene through its own parser); a tensorf run resumed across a
grid upsample equals one that never stopped, bit for bit; the one method
still unported names its ROADMAP item."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)
import torch

from test_torch_cli import TINY
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.engine.trainer import read_checkpoint
from nerfstudio_torch.scripts import eval as teval
from nerfstudio_torch.scripts import gate, train
from nerfstudio_torch.utils.eval_utils import eval_setup

REPO = Path(__file__).resolve().parent.parent
CPU_RUN = ["--machine.device_type", "cpu", "--trainer.vis", "none"]
# each method at a CPU size: tensorf's grids at 16 growing at steps 2 and 4,
# the NeRFs at 8 + 8 samples (their fields keep the shipped widths)
SMALL = {
    "tensorf": ["--model.init_resolution", "16", "--model.final_resolution", "24", "--model.upsampling_iters", "2,4",
                "--model.num_uniform_samples", "8", "--model.num_samples", "8", "--model.num_den_components", "4",
                "--model.num_color_components", "8", "--datamanager.train_num_rays_per_batch", "64",
                "--model.eval_num_rays_per_chunk", "256"],
    "vanilla-nerf": ["--model.num_coarse_samples", "8", "--model.num_importance_samples", "8",
                     "--datamanager.train_num_rays_per_batch", "32", "--model.eval_num_rays_per_chunk", "256"],
    "mipnerf": ["--model.num_coarse_samples", "8", "--model.num_importance_samples", "8",
                "--datamanager.train_num_rays_per_batch", "32", "--model.eval_num_rays_per_chunk", "256"],
    "dnerf": ["--model.num_coarse_samples", "8", "--model.num_importance_samples", "8",
              "--datamanager.train_num_rays_per_batch", "32", "--model.eval_num_rays_per_chunk", "256"],
}


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    """The tool's ``blender`` scene at 16^2: 4 RGBA train views, 2 test."""
    root = tmp_path_factory.mktemp("scenes") / "blender"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"), str(root), "--scene", "blender",
                    "--hw", "16", "--n-train", "4", "--n-test", "2", "--n-points", "100"], check=True,
                   capture_output=True, timeout=300)
    return root


@pytest.fixture(scope="module")
def dnerf_scene(blender):
    """The tool's time-varying ``dnerf`` scene at 16^2 beside ``blender``:
    4 RGBA train views at times 0, 1/3, 2/3 and 1, 2 val and 2 test."""
    root = blender.parent / "dnerf"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"), str(root), "--scene", "dnerf",
                    "--hw", "16", "--n-train", "4", "--n-test", "2", "--n-points", "100"], check=True,
                   capture_output=True, timeout=300)
    return root


def test_nerfacto_evaluates_over_white_through_the_blender_parser(blender, tmp_path, capsys):
    """``scripts/train.py nerfacto --dataparser blender-data`` (the parser's
    ``alpha_color`` white) trains 3 steps with an eval batch and an eval
    image on the way, then ``scripts/eval.py`` evaluates its checkpoint.
    The eval renders composite onto white: with the density zeroed (the
    accumulation 0 everywhere) the eval image is white, where nerfacto's own
    ``last_sample`` background would show the last sample's colour."""
    train.main(["nerfacto", "--data", str(blender), "--dataparser", "blender-data", *CPU_RUN, *TINY,
                "--trainer.output_dir", str(tmp_path / "out"), "--trainer.max_num_iterations", "3",
                "--trainer.steps_per_eval_image", "2", "--trainer.steps_per_eval_batch", "1",
                "--trainer.timestamp", "run"])
    out = capsys.readouterr().out
    assert "[eval 2]" in out and "[eval_batch 1]" in out
    run = tmp_path / "out" / "blender" / "nerfacto" / "run"
    info = teval.main([str(run), "--output-path", str(tmp_path / "eval.json")])
    assert info["step"] == 3 and {"psnr", "ssim"} <= set(info["results"])
    _, pipeline, state = eval_setup(run)
    assert torch.equal(pipeline._eval_background(), torch.ones(3))
    pipeline.model.field.average_init_density = 0.0
    images = pipeline.render_eval_camera(state, 0)
    assert float(images["accumulation"].max()) == 0.0
    assert torch.equal(images["rgb"], torch.ones_like(images["rgb"]))
    with torch.no_grad():
        rays = pipeline.datamanager.eval_cameras.generate_rays(camera_indices=0).flatten()
        plain = pipeline.model.eval()(rays, model_aux=state.aux)
    assert not torch.equal(plain["rgb"], torch.ones_like(plain["rgb"]))  # the last sample's colour, not white


@pytest.mark.parametrize("method", sorted(SMALL))
def test_train_eval_and_gate_of_the_blender_methods(method, blender, dnerf_scene, tmp_path, capsys):
    """Two steps through ``scripts/train.py`` (the shipped parser: the
    Blender one, white ``alpha_color``; dnerf's D-NeRF parser on the
    ``dnerf`` scene) and ``scripts/eval.py`` on its checkpoint; then
    ``scripts/gate.py``'s runner for two steps: the ``blender`` cell over
    white, through the Blender parser, beside its JAX record
    (``benchmarks/gate_<method>_blender.json``) at the record's steps; for
    dnerf also the ``dnerf`` cell through its own parser, whose cameras
    carry the frames' times, with no JAX record beside it."""
    scene = dnerf_scene if method == "dnerf" else blender
    train.main([method, "--data", str(scene), *CPU_RUN, *SMALL[method], "--trainer.output_dir", str(tmp_path / "out"),
                "--trainer.max_num_iterations", "2", "--trainer.timestamp", "run"])
    assert "[train 0]" in capsys.readouterr().out
    run = tmp_path / "out" / scene.name / method / "run"
    info = teval.main([str(run), "--output-path", str(tmp_path / "eval.json")])
    assert info["step"] == 2 and {"psnr", "ssim"} <= set(info["results"])
    result, gate_run = gate.run_gate(method, blender, tmp_path / "gate", steps=2, overrides=["--machine.device_type",
                                                                                            "cpu", *SMALL[method]])
    record = json.loads((REPO / "benchmarks" / f"gate_{method.replace('-', '_')}_blender.json").read_text())
    assert result["scene"] == "blender" and result["steps"] == 2
    assert result["jax_record"] == {"psnr": record["metrics"]["psnr"], "ssim": record["metrics"]["ssim"]}
    assert gate.GATE_STEPS[method] == record["steps"] == {"tensorf": 5000}.get(method, 8000)
    dm = gate_run["pipeline"].datamanager
    assert torch.equal(dm.eval_dataset.alpha_color, torch.ones(3)) and len(dm.eval_dataset) == 2
    assert dm.train_images.shape[-1] == 4  # RGBA: the loss blends it over the renderer's white
    assert dm.train_cameras.times is None
    if method == "dnerf":
        result, gate_run = gate.run_gate(method, dnerf_scene, tmp_path / "gate_dnerf", steps=2,
                                         overrides=["--machine.device_type", "cpu", *SMALL[method]])
        assert result["scene"] == "dnerf" and result["jax_record"] is None and math.isfinite(result["metrics"]["psnr"])
        dm = gate_run["pipeline"].datamanager
        np.testing.assert_allclose(dm.train_cameras.times[:, 0].numpy(), [0, 1 / 3, 2 / 3, 1], rtol=1e-6)
        assert dm.eval_cameras.times is not None and len(dm.eval_dataset) == 2


def test_tensorf_resume_across_an_upsample_is_bit_equal(blender, tmp_path):
    """A tensorf run of 6 steps (grids 16 -> 20 at step 2, -> 24 at step 4,
    each time the optimizer re-initialised) saved at step 3, and a second
    run resumed from that save to step 6: the model is rebuilt at the saved
    resolution (20), then grows at step 4 as the first run's did; both
    step-6 checkpoints are equal tensor for tensor (the model, every Adam
    moment and count, the generator)."""
    common = ["tensorf", "--data", str(blender), *CPU_RUN, *SMALL["tensorf"], "--trainer.output_dir",
              str(tmp_path / "out"), "--trainer.max_num_iterations", "6", "--trainer.steps_per_save", "3",
              "--trainer.save_only_latest_checkpoint", "false", "--trainer.steps_per_eval_batch", "0",
              "--trainer.steps_per_eval_image", "0"]
    train.main(common + ["--trainer.timestamp", "run1"])
    run1 = tmp_path / "out" / "blender" / "tensorf" / "run1" / "nerfstudio_models"
    _, saved = read_checkpoint(run1, 3)
    assert saved["model"]["field.density_encoding.plane_coef"].shape[-1] == 20 and saved["optimizer"]["count"] == 1
    train.main(common + ["--trainer.timestamp", "run2", "--trainer.load_dir", str(run1), "--trainer.load_step", "3"])
    run2 = tmp_path / "out" / "blender" / "tensorf" / "run2" / "nerfstudio_models"
    (_, a), (_, b) = read_checkpoint(run1, 6), read_checkpoint(run2, 6)
    assert a["model"]["field.color_encoding.line_coef"].shape[-1] == 24 and a["optimizer"]["count"] == 2

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y

    assert same(a, b)


def test_unported_methods_name_their_current_items():
    """No method is refused any more: generfacto (item 14) is ported, its
    config equal to JAX's field by field; dnerf (with the D-NeRF parser and
    the cameras' times), instant-ngp and its bounded variant are ported."""
    from nerfstudio_torch.configs.method_configs import NOT_PORTED
    from test_torch_vanilla_mipnerf import test_method_config_matches_jax as same_config

    assert NOT_PORTED == {}
    same_config("generfacto")
    for method in ("tensorf", "vanilla-nerf", "mipnerf", "dnerf", "instant-ngp", "instant-ngp-bounded", "generfacto"):
        assert get_method(method).method_name == method
