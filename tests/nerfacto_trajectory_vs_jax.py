"""nerfacto's quality trajectory, JAX package against the port, on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/nerfacto_trajectory_vs_jax.py SCENE STEPS EVERY {jax,torch,paired} [field=value ...]

Each side builds nerfacto from its own method config on the scene (the
nerfstudio parser at ``train_split_fraction=0.9``, downscale 1), sets the
fields given as ``field=value`` (model fields, ``datamanager.x=value``, or
``seed=N`` for the config's seed; the same on both sides), trains through
its own ``Trainer`` with its own draws from ``config.seed`` and prints,
every EVERY steps, one JSON line: the mean PSNR and SSIM over the held-out
views and, with ``predict_normals=True``, the orientation and
predicted-normal loss terms, each the mean over the window's every tenth
step (``terms``). ``paired`` trains both sides in one process from JAX's init on
JAX's draws (``run_paired``) and prints both sides' numbers, JAX's first.
Not a test: a witness that the two trainers follow the same trajectory on
a capture (distorted, masked, basic, unbounded). Run one process per side,
e.g. on ``tools/make_synthetic_dataset.py SCENE --scene distorted --hw 64
--n-train 16 --n-test 4 --n-points 2000``."""

import json
import sys
import tempfile
import time
from pathlib import Path


def _configure(config, parser_cls, scene: Path, steps: int, fields: dict):
    config.data = scene
    config.dataparser = parser_cls(data=scene, train_split_fraction=0.9, downscale_factor=1)
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


TERMS = ("orientation_loss", "pred_normal_loss")


def _window(terms, metrics, step):
    """Add every tenth step's loss terms to ``terms``; return and clear their
    means at the end of a window."""
    if step % 10 == 0:
        for k in TERMS:
            if k in metrics:
                terms.setdefault(k, []).append(float(metrics[k]))


def _means(terms):
    out = {k: sum(v) / len(v) for k, v in terms.items() if v}
    terms.clear()
    return out


def run_jax(scene, steps, every, fields):
    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_tpu.pipelines.factory import build_trainer

    config = _configure(get_method("nerfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    trainer = build_trainer(config, use_mesh=False)
    t0, terms = time.time(), {}
    for step in range(steps):
        _window(terms, trainer.train_iteration(step), step)
        if (step + 1) % every == 0:
            m = trainer.pipeline.get_average_eval_image_metrics(trainer.state)
            yield dict(step=step + 1, psnr=m["psnr"], ssim=m["ssim"], terms=_means(terms), seconds=time.time() - t0)


def run_torch(scene, steps, every, fields):
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.pipelines.factory import build_trainer

    config = _configure(get_method("nerfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    config.machine.device_type = "cpu"
    trainer = build_trainer(config)
    t0, terms = time.time(), {}
    for step in range(steps):
        _window(terms, trainer.train_iteration(step), step)
        if (step + 1) % every == 0:
            m = trainer.pipeline.get_average_eval_image_metrics(trainer.state)
            yield dict(step=step + 1, psnr=m["psnr"], ssim=m["ssim"], terms=_means(terms), seconds=time.time() - t0)


def run_paired(scene, steps, every, fields):
    """Both sides in one process from JAX's init, each step on JAX's draws:
    the port takes the pixels and the sampler's jitter of JAX's step key
    and the cells and jitter of its occupancy key (``_torch_port``'s
    helpers). The two still part, slowly: K1 hashes the samples' float
    bits, which the two packages round alike only mostly."""
    import jax

    from _torch_port import jax_occupancy_draws, jax_step_draws
    from nerfstudio_tpu.configs.method_configs import get_method as jget_method
    from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JParser
    from nerfstudio_tpu.pipelines.factory import build_pipeline as jbuild_pipeline
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.engine.trainer import restore_train_state
    from nerfstudio_torch.pipelines.factory import build_pipeline
    from nerfstudio_torch.utils.convert import trainer_checkpoint_from_jax

    jconfig = _configure(jget_method("nerfacto"), JParser, scene, steps, fields)
    jpipe, jstate, jconfig = jbuild_pipeline(jconfig, use_mesh=False)
    config = _configure(get_method("nerfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    config.machine.device_type = "cpu"
    pipe, state, config = build_pipeline(config)
    restore_train_state(pipe, state, trainer_checkpoint_from_jax(jax.device_get(jstate), pipe.model, state.optimizer))
    cfg, rays = config.model, config.datamanager.train_num_rays_per_batch
    n, h, w = pipe.datamanager.train_images.shape[:3]
    t0 = time.time()
    for step in range(steps):
        k_aux, k_step = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(config.seed), step))
        kwargs = type(pipe.model).step_kwargs(step, cfg)
        jstate = jpipe.aux_update_fn(jstate, step, k_aux)
        jstate, _ = jpipe.train_step(jstate, jpipe.datamanager.train_images, k_step, **kwargs)
        if step >= cfg.occ_warmup_steps and step % cfg.occ_update_every == 0:
            cells, jitter = jax_occupancy_draws(k_aux, cfg.occ_grid_resolution, cfg.occ_cells_per_update)
            pipe.aux_update_fn(state, step, cells=cells, jitter=jitter)
        state.step = step
        pipe.train_step(state, draws=jax_step_draws(k_step, rays, n, h, w), **kwargs)
        if (step + 1) % every == 0:
            jm = jpipe.get_average_eval_image_metrics(jstate)
            tm = pipe.get_average_eval_image_metrics(state)
            occupied = (float(jax.numpy.mean(jstate.aux.binary)), float(state.aux.binary.float().mean()))
            yield dict(step=step + 1, psnr=(jm["psnr"], tm["psnr"]), ssim=(jm["ssim"], tm["ssim"]),
                       occupied=occupied, seconds=time.time() - t0)


def main(argv):
    scene, steps, every, side = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    fields = dict(a.split("=", 1) for a in argv[4:])
    run = {"jax": run_jax, "torch": run_torch, "paired": run_paired}[side]
    for rec in run(scene, steps, every, fields):
        print(json.dumps(dict(side=side, scene=scene.name, **rec)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
