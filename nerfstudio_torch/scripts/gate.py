"""Quality gate of a method on a synthetic scene (counterpart of
``tools/run_gate_matrix.py``'s ``run_gate`` for the ported methods on the
scenes of ``tools/make_synthetic_dataset.py``: ``basic``, ``blender``,
``distorted``, ``masked``, ``semantic``, ``appearance``; the cell is named
after the scene's directory):

    python -m nerfstudio_torch.scripts.gate METHOD SCENE_DIR OUT.json [--steps N] [--a.b value ...]

The method's shipped config, read through the nerfstudio parser at
``train_split_fraction=0.9`` and downscale 1, is trained for the method's
gate steps (``GATE_STEPS``, as in ``benchmarks/gate_*.json``) through the
loop ``scripts.train`` runs, with every eval cadence and intermediate save
off, then every held-out view is rendered (ray methods in 16,384-ray
chunks, or the model's own eval chunk where it is smaller). A method that
ships the nerfstudio parser keeps its ``load_3D_points`` (depth-nerfacto's
SfM depth). Given a ``basic`` scene, semantic-nerfw trains on the
``semantic`` scene beside it and phototourism on ``appearance``
(``SCENE_ROUTES``, the JAX runner's routes). A method of
``BLENDER_METHODS`` (neus, tensorf, vanilla-nerf, mipnerf, instant-ngp and
instant-ngp-bounded) reads the Blender format instead, on any scene but
``distorted`` and ``masked`` (the ``blender`` scene beside a given ``basic``
one), with its train split and every test view: a method that renders over
black (instant-ngp-bounded) takes the ground truth RGBA, blended over black
for the loss and the metrics; any other (instant-ngp's random background
too) reads it blended over white at load (``alpha_color="white"``) and
evaluates over white (the JAX runner's route). The
JSON has the keys of ``benchmarks/gate_nerfacto.json``, the card's name
and power limit, and the kernel launches of training and eval. The gates:
PSNR > 20 and SSIM > 0.7. Beside the result stands the JAX package's
record of the same cell (``benchmarks/gate_<method>[_<scene>].json``, the
method's hyphens as underscores, the ``basic`` scene without a suffix), its PSNR and SSIM only: its times were
taken on another accelerator. ``--a.b value`` flags override the config
(``--machine.device_type cpu`` runs on the CPU); any other than the machine
marks the run as not at shipped defaults. ``--model.predict-normals True``
makes a cell of its own (on ``basic``: ``basic_normals``): no JAX record
stands beside it, and its two loss terms are reported, the mean of the
first and of the last quarter of their logged values (``loss_terms``)."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

GATE_STEPS = {"nerfacto": 5000, "nerfacto-big": 3000, "nerfacto-huge": 1500, "depth-nerfacto": 5000,
              "semantic-nerfw": 5000, "phototourism": 5000, "neus": 12000, "splatfacto": 8000,
              "splatfacto-big": 8000, "splatfacto-mcmc": 8000, "tensorf": 5000, "vanilla-nerf": 8000,
              "mipnerf": 8000, "instant-ngp": 5000, "instant-ngp-bounded": 3000}
# methods the JAX runner trains on the Blender protocol (tools/run_gate_matrix.py:64-65)
BLENDER_METHODS = ("neus", "tensorf", "vanilla-nerf", "mipnerf", "instant-ngp", "instant-ngp-bounded")
# the scene beside a given basic one that exercises a method's own machinery
# (tools/run_gate_matrix.py:94-105): the labels, the per-view exposure
SCENE_ROUTES = {"semantic-nerfw": "semantic", "phototourism": "appearance"}
# the loss terms of nerfacto's predicted normals, a cell the JAX package has
# no record of
NORMALS_TERMS = ("orientation_loss", "pred_normal_loss")
RECORDS = Path(__file__).resolve().parents[2] / "benchmarks"
PSNR_GATE, SSIM_GATE = 20.0, 0.7
EVAL_CHUNK = 1 << 14
BLOCK = 1000  # steps between the host-clock readings of the training time


def card() -> Dict[str, str]:
    """The card's name and power limit, as nvidia-smi reports them."""
    if not torch.cuda.is_available():
        return {"device": "cpu", "power_limit": "none"}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"device": name, "power_limit": limit}


def jax_record(method: str, scene: str) -> Optional[Dict[str, float]]:
    """PSNR and SSIM of the JAX package's gate record of the cell, None
    where the repo has none."""
    path = RECORDS / f"gate_{method.replace('-', '_')}{'' if scene == 'basic' else '_' + scene}.json"
    if not path.is_file():
        return None
    metrics = json.loads(path.read_text(encoding="utf-8"))["metrics"]
    return {"psnr": metrics["psnr"], "ssim": metrics["ssim"]}


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launches so far."""
    from nerfstudio_torch.ops import hash_grid
    from nerfstudio_torch.ops.gsplat import _cuda

    return {**hash_grid.launch_counts, **_cuda.launch_counts}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_gate(method: str, scene_dir: Path, run_dir: Path, steps: Optional[int] = None,
             overrides: Optional[List[str]] = None) -> Tuple[dict, Dict[str, Any]]:
    """Train and evaluate one gate cell through the user's own loop, its
    run directory (scalars, the final checkpoint) under ``run_dir``:
    ``Trainer.train`` for a ray method, ``SplatPipeline.train`` with the
    writer and a final save as ``train_splat`` runs it for splatfacto. The
    training time is the whole loop's, host syncs and writes included.
    Returns (the result record, {"pipeline", "state", "one_step",
    "base_dir"}), where ``one_step()`` trains one more step of the same
    loop and ``base_dir`` holds the run's scalars."""
    from nerfstudio_torch.configs.cli import apply_overrides
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig

    if method not in GATE_STEPS:
        raise NotImplementedError(f"the gate runner takes {sorted(GATE_STEPS)}, not {method!r}")
    steps = steps or GATE_STEPS[method]
    config = get_method(method)
    scene_dir = Path(scene_dir)
    route = SCENE_ROUTES.get(method)
    if route and scene_dir.name == "basic" and (scene_dir.parent / route).is_dir():
        scene_dir = scene_dir.parent / route
    if method in BLENDER_METHODS and scene_dir.name not in ("distorted", "masked"):
        if scene_dir.name == "basic" and (scene_dir.parent / "blender").is_dir():
            scene_dir = scene_dir.parent / "blender"
        alpha = None if getattr(config.model, "background_color", "") == "black" else "white"
        config.dataparser = BlenderDataParserConfig(data=scene_dir, alpha_color=alpha)
    else:
        config.dataparser = NerfstudioDataParserConfig(
            data=scene_dir, train_split_fraction=0.9, downscale_factor=1,
            load_3D_points=getattr(config.dataparser, "load_3D_points", False))
    config.data = scene_dir
    t = config.trainer
    t.max_num_iterations, t.output_dir, t.experiment_name, t.timestamp, t.vis = (
        steps, Path(run_dir), scene_dir.name, "gate", "none")
    t.steps_per_eval_batch = t.steps_per_eval_image = t.steps_per_eval_all_images = t.steps_per_save = 0
    overrides = list(overrides or [])
    rest = apply_overrides(config, overrides)
    if rest:
        raise SystemExit(f"unrecognized arguments: {rest}")
    model_overrides = {overrides[i][2:]: overrides[i + 1] for i in range(0, len(overrides) - 1, 2)
                       if not overrides[i].startswith("--machine.")}
    normals = bool(getattr(config.model, "predict_normals", False))
    result = {"method": method, "scene": scene_dir.name, "cell": scene_dir.name + ("_normals" if normals else ""),
              "steps": steps, "shipped_defaults": not model_overrides, "overrides": model_overrides,
              "gates": {"psnr": PSNR_GATE, "ssim": SSIM_GATE},
              "jax_record": None if normals else jax_record(method, scene_dir.name), **card()}
    before = launch_counts()
    blocks = []
    eval_chunk = EVAL_CHUNK

    if isinstance(config.model, SplatfactoModelConfig):
        from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline
        from nerfstudio_torch.utils.writer import EventWriter

        pipeline, state = build_splat_pipeline(config)
        device = state.params["means"].device
        gen = torch.Generator(device=device).manual_seed(config.seed)
        base = t.get_base_dir()
        writer = EventWriter(base, vis=t.vis)
        cams = pipeline.datamanager.train_cameras
        _sync(device)
        t0 = time.perf_counter()
        start = 0
        for end in list(range(BLOCK, steps, BLOCK)) + [steps]:
            tb = time.perf_counter()
            state, metrics = pipeline.train(state, end, gen, writer=writer)
            _sync(device)
            blocks.append((time.perf_counter() - tb) * 1e3 / (end - start))
            start = end
        pipeline.save_checkpoint(state, t.get_checkpoint_dir(base), state.step, gen)
        _sync(device)
        train_s = time.perf_counter() - t0
        loss = float(metrics["loss"])
        # pixels rendered per step at the resolution schedule's downscale
        pixels = sum((int(cams.height[0, 0]) // pipeline.model.downscale_at(s)) *
                     (int(cams.width[0, 0]) // pipeline.model.downscale_at(s)) for s in range(steps))
        result["train_rays_per_sec"] = pixels / train_s
        result["num_alive"] = int(state.aux.alive.sum())
        after_train = launch_counts()
        eval_metrics = pipeline.get_average_eval_image_metrics(state)

        def one_step():
            return pipeline.train(state, state.step + 1, gen)[1]
    else:
        from nerfstudio_torch.pipelines.factory import build_trainer

        trainer = build_trainer(config)
        pipeline, state, device = trainer.pipeline, trainer.state, trainer.pipeline.device
        eval_chunk = min(EVAL_CHUNK, config.model.eval_num_rays_per_chunk)
        last, step_once = {}, trainer.train_iteration
        tick = [0.0]

        def iteration(step):
            last["metrics"] = step_once(step)
            if (step + 1) % BLOCK == 0 or step + 1 == steps:  # one sync per block
                _sync(device)
                now = time.perf_counter()
                blocks.append((now - tick[0]) * 1e3 / ((step % BLOCK) + 1))
                tick[0] = now
            return last["metrics"]

        trainer.train_iteration = iteration
        _sync(device)
        t0 = tick[0] = time.perf_counter()
        trainer.train()
        _sync(device)
        train_s = time.perf_counter() - t0
        trainer.train_iteration = step_once
        loss = float(last["metrics"]["loss"])
        result["train_rays_per_sec"] = config.datamanager.train_num_rays_per_batch * steps / train_s
        after_train = launch_counts()
        eval_metrics = pipeline.get_average_eval_image_metrics(state, chunk_size=eval_chunk)

        def one_step():
            return trainer.train_iteration(int(state.step))
    if not math.isfinite(loss):
        raise AssertionError(f"{method} diverged: loss {loss} at step {steps - 1}")
    after_eval = launch_counts()
    result["train_seconds"] = train_s
    result["steps_per_sec"] = steps / train_s
    # host clock, each block synced; the last block holds the final save
    result["step_ms_by_block"] = {"steps_per_block": BLOCK, "ms": blocks}
    result["final_loss"] = loss
    result["eval_config"] = {"eval_chunk": eval_chunk,
                             # a block-layout field renders with K3 unless the config asks otherwise
                             "exact_eval_trilerp": bool(getattr(config.model, "eval_exact_trilerp",
                                                                getattr(config.model, "field_block", False))),
                             "hash_block_layout": bool(getattr(config.model, "field_block", False))}
    result["metrics"] = {k: round(float(v), 4) for k, v in eval_metrics.items()}
    result["launches"] = {"train": {k: after_train[k] - before[k] for k in before},
                          "eval": {k: after_eval[k] - after_train[k] for k in before}}
    if normals:
        result["loss_terms"] = loss_terms(t.get_base_dir(), NORMALS_TERMS)
    result["pass_psnr"] = bool(eval_metrics["psnr"] > PSNR_GATE)
    result["pass_ssim"] = bool(eval_metrics["ssim"] > SSIM_GATE)
    result["pass"] = result["pass_psnr"] and result["pass_ssim"]
    return result, {"pipeline": pipeline, "state": state, "one_step": one_step, "base_dir": t.get_base_dir()}


def loss_terms(base_dir: Path, keys) -> Dict[str, Dict[str, float]]:
    """Per loss term of ``keys``: the mean of the first and of the last
    quarter of the train values the writer logged (``scalars.jsonl``), and
    whether every value is finite and the last quarter's mean is lower."""
    with open(Path(base_dir) / "scalars.jsonl", encoding="utf-8") as f:
        rows = [r for r in map(json.loads, f) if r["prefix"] == "train"]
    out = {}
    for k in keys:
        vals = [float(r[k]) for r in rows if k in r]
        q = max(len(vals) // 4, 1)
        head, tail = sum(vals[:q]) / q, sum(vals[-q:]) / q
        out[k] = {"first_quarter": head, "last_quarter": tail, "logged": len(vals),
                  "fell": all(map(math.isfinite, vals)) and tail < head}
    return out


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return {}
    method, scene_dir, out = argv[0], Path(argv[1]), Path(argv[2])
    rest, steps = argv[3:], None
    if "--steps" in rest:
        i = rest.index("--steps")
        steps = int(rest[i + 1])
        rest = rest[:i] + rest[i + 2:]
    with tempfile.TemporaryDirectory(prefix="gate_") as run_dir:
        result, _ = run_gate(method, scene_dir, Path(run_dir), steps, overrides=rest)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1), encoding="utf-8")
    print(json.dumps(result), flush=True)
    print(f"wrote {out}", flush=True)
    return result


if __name__ == "__main__":
    main()
