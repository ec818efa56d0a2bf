"""dnerf's quality trajectory, JAX package against the port, on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/dnerf_trajectory_vs_jax.py SCENE STEPS EVERY SIDE [field=value ...]

SIDE is ``jax``, ``torch`` or ``paired``.

Each side builds dnerf from its own method config on the time-varying
scene (``tools/make_synthetic_dataset.py --scene dnerf``) through its own
D-NeRF parser, sets the fields given as ``field=value`` (model fields,
``datamanager.x=value``, ``seed=N``, or ``float32_mlps=1`` for every MLP
and head in float32; the same on both sides; ``paired`` also takes
``distortion_out_scale=S``, JAX's init of the deformation's output layer
times S, as the one-step test's ``_gentle``), trains
through its own ``Trainer`` with its own draws from ``config.seed`` and
prints, every EVERY steps, one JSON line: the mean PSNR and SSIM over the
held-out (val) views, the mean of the window's train losses (every tenth
step's), and the mean |offset| of the deformation net over the first val
view's coarse midpoints (``offset``). ``paired`` trains both sides in one
process from JAX's init on JAX's draws (``run_paired``) and prints both
sides' offsets and losses, JAX's first. Not a test: a witness of whether the
reference follows the port's trajectory on the scene, e.g. on
``tools/make_synthetic_dataset.py SCENE --scene dnerf --hw 64 --n-train 16
--n-test 4 --n-points 2000`` with ``num_coarse_samples=32
num_importance_samples=64 datamanager.train_num_rays_per_batch=256``."""

import json
import sys
import tempfile
import time
from pathlib import Path


FLOAT32 = "float32_mlps"  # field name: every MLP and head computes its products in float32 (both sides)
GENTLE = "distortion_out_scale"  # field name (paired): the deformation's output layer at JAX's init times this


def _jax_float32():
    """JAX's NeRF fields' MLPs and heads and the distortion's MLP in float32."""
    import functools

    import jax.numpy as jnp

    import nerfstudio_tpu.field_components.temporal_distortions as jtd
    import nerfstudio_tpu.fields.vanilla_nerf_field as jfield
    from nerfstudio_tpu.field_components import field_heads, mlp

    f32 = dict(dtype=jnp.float32)
    jfield.MLP = jtd.MLP = functools.partial(mlp.MLP, **f32)
    jfield.DensityFieldHead = functools.partial(field_heads.DensityFieldHead, **f32)
    jfield.RGBFieldHead = functools.partial(field_heads.RGBFieldHead, **f32)


def _torch_float32(model):
    import torch

    from nerfstudio_torch.field_components.field_heads import FieldHead
    from nerfstudio_torch.field_components.mlp import MLP

    for m in model.modules():
        if isinstance(m, (MLP, FieldHead)):
            m.dtype = torch.float32


def _configure(config, parser_cls, scene: Path, steps: int, fields: dict):
    fields = {k: v for k, v in fields.items() if k not in (FLOAT32, GENTLE)}
    config.data = scene
    config.dataparser = parser_cls(data=scene)
    config.trainer.max_num_iterations = steps
    config.trainer.output_dir = Path(tempfile.mkdtemp(prefix="trajectory_"))
    config.trainer.vis = "none"
    for k, v in fields.items():
        if k == "seed":
            config.seed = int(v)
            continue
        target, name = (config.datamanager, k.split(".", 1)[1]) if k.startswith("datamanager.") else (config.model, k)
        setattr(target, name, type(getattr(target, name))(v))
    return config


def _record(step, metrics, losses, offset, t0):
    return dict(step=step, psnr=metrics["psnr"], ssim=metrics["ssim"], loss=sum(losses) / len(losses),
                offset=offset, seconds=time.time() - t0)


def run_jax(scene, steps, every, fields):
    import jax
    import jax.numpy as jnp

    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig
    from nerfstudio_tpu.pipelines.factory import build_trainer

    if fields.get(FLOAT32):
        _jax_float32()
    config = _configure(get_method("dnerf"), DNeRFDataParserConfig, scene, steps, fields)
    trainer = build_trainer(config, use_mesh=False)
    cams = trainer.pipeline.datamanager.eval_cameras
    rb = cams.generate_rays(camera_indices=0).flatten()
    cfg = config.model
    t = jnp.linspace(cfg.collider_params["near_plane"], cfg.collider_params["far_plane"], cfg.num_coarse_samples + 1)
    mids = rb.origins[:, None] + rb.directions[:, None] * ((t[:-1] + t[1:]) / 2)[None, :, None]
    times = jnp.broadcast_to(rb.times[:, None], mids.shape[:-1] + (1,))
    t0, losses = time.time(), []
    for step in range(steps):
        metrics = trainer.train_iteration(step)
        if step % 10 == 0:
            losses.append(float(metrics["loss"]))
        if (step + 1) % every == 0:
            params = trainer.state.params
            moved = trainer.pipeline.model_eval.apply(
                params, mids, times, method=lambda m, x, tt: m.temporal_distortion(x, tt)) - mids
            offset = float(jnp.mean(jnp.linalg.norm(moved, axis=-1)))
            m = trainer.pipeline.get_average_eval_image_metrics(trainer.state)
            yield _record(step + 1, m, losses, offset, t0)
            losses = []


def run_torch(scene, steps, every, fields):
    import torch

    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig
    from nerfstudio_torch.pipelines.factory import build_trainer

    config = _configure(get_method("dnerf"), DNeRFDataParserConfig, scene, steps, fields)
    config.machine.device_type = "cpu"
    trainer = build_trainer(config)
    model = trainer.pipeline.model
    if fields.get(FLOAT32):
        _torch_float32(model)
    rb = trainer.pipeline.datamanager.eval_cameras.generate_rays(camera_indices=0).flatten()
    cfg = config.model
    t = torch.linspace(cfg.collider_params["near_plane"], cfg.collider_params["far_plane"], cfg.num_coarse_samples + 1)
    mids = rb.origins[:, None] + rb.directions[:, None] * ((t[:-1] + t[1:]) / 2)[None, :, None]
    times = rb.times[:, None].expand(mids.shape[:-1] + (1,))
    t0, losses = time.time(), []
    for step in range(steps):
        metrics = trainer.train_iteration(step)
        if step % 10 == 0:
            losses.append(float(metrics["loss"]))
        if (step + 1) % every == 0:
            with torch.no_grad():
                offset = float((model.temporal_distortion(mids, times) - mids).norm(dim=-1).mean())
            m = trainer.pipeline.get_average_eval_image_metrics(trainer.state)
            yield _record(step + 1, m, losses, offset, t0)
            losses = []


def run_paired(scene, steps, every, fields):
    """Both sides in one process from JAX's init, each step on the draws of
    JAX's step key (``fold_in(PRNGKey(seed), step)``): the port takes its
    pixels (as ``_torch_port.jax_step_draws`` draws them) and the uniform
    and PDF samplers' jitter (the model key's first two thirds). Yields
    each side's mean window loss and mean |offset| over the first val
    view's coarse midpoints."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from _torch_port import to_torch
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig as JParser
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.extra_dataparsers import DNeRFDataParserConfig
    from nerfstudio_torch.engine.trainer import restore_train_state
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws
    from nerfstudio_torch.pipelines.factory import build_pipeline
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    if fields.get(FLOAT32):
        _jax_float32()
    jconfig = _configure(jget_method("dnerf"), JParser, scene, steps, fields)
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    if fields.get(GENTLE):
        params = jax.device_get(jstate.params)
        out = params["params"]["temporal_distortion"]["MLP_0"]["layers_3"]
        out["kernel"] = out["kernel"] * np.float32(fields[GENTLE])
        jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    config = _configure(get_method("dnerf"), DNeRFDataParserConfig, scene, steps, fields)
    config.machine.device_type = "cpu"
    pipe, state, config = build_pipeline(config)
    if fields.get(FLOAT32):
        _torch_float32(pipe.model)
    restore_train_state(pipe, state, trainer_checkpoint_from_jax(jax.device_get(jstate), pipe.model, state.optimizer))
    cfg, rays = config.model, config.datamanager.train_num_rays_per_batch
    n, h, w = pipe.datamanager.train_images.shape[:3]
    rb = pipe.datamanager.eval_cameras.generate_rays(camera_indices=0).flatten()
    t = torch.linspace(cfg.collider_params["near_plane"], cfg.collider_params["far_plane"], cfg.num_coarse_samples + 1)
    mids = rb.origins[:, None] + rb.directions[:, None] * ((t[:-1] + t[1:]) / 2)[None, :, None]
    times = rb.times[:, None].expand(mids.shape[:-1] + (1,))
    jmids, jtimes = jnp.asarray(mids.numpy()), jnp.asarray(times.numpy())

    def offsets():
        with torch.no_grad():
            ours = float((pipe.model.temporal_distortion(mids, times) - mids).norm(dim=-1).mean())
        moved = jpipe.model_eval.apply(jstate.params, jmids, jtimes,
                                       method=lambda m, x, tt: m.temporal_distortion(x, tt)) - jmids
        return float(jnp.mean(jnp.linalg.norm(moved, axis=-1))), ours

    t0, losses = time.time(), []
    for step in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(config.seed), step)
        jstate, jm = jpipe.train_step(jstate, jpipe.datamanager.train_images, key)
        k_pix, k_model = jax.random.split(key)
        kc, kr, kw = jax.random.split(k_pix, 3)
        pixels = np.stack([np.asarray(jax.random.randint(k, (rays,), 0, m)) for k, m in ((kc, n), (kr, h), (kw, w))],
                          axis=-1).astype(np.int64)
        k1, k2, _ = jax.random.split(k_model, 3)
        jitter = (to_torch(jax.random.uniform(k1, (rays, cfg.num_coarse_samples + 1))),
                  to_torch(jax.random.uniform(k2, (rays, cfg.num_importance_samples + 1))))
        state.step = step
        tm = pipe.train_step(state, draws=StepDraws(to_torch(pixels), SamplerUniforms(None, jitter)))
        losses.append((float(jm["loss"]), float(tm["loss"])))
        if (step + 1) % every == 0:
            yield dict(step=step + 1, loss=tuple(sum(x) / len(losses) for x in zip(*losses)), offset=offsets(),
                       seconds=time.time() - t0)
            losses = []


def main(argv):
    scene, steps, every, side = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    fields = dict(a.split("=", 1) for a in argv[4:])
    run = {"jax": run_jax, "torch": run_torch, "paired": run_paired}[side]
    for rec in run(scene, steps, every, fields):
        print(json.dumps(dict(side=side, scene=scene.name, **rec)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
