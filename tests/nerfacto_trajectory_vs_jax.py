"""nerfacto's quality trajectory, JAX package against the port, on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/nerfacto_trajectory_vs_jax.py SCENE STEPS EVERY {jax,torch} [field=value ...]

Each side builds nerfacto from its own method config on the scene (the
nerfstudio parser at ``train_split_fraction=0.9``, downscale 1), sets the
fields given as ``field=value`` (model fields, or ``datamanager.x=value``;
the same on both sides), trains through its own ``Trainer`` with its own
draws from ``config.seed`` and prints, every EVERY steps, one JSON line:
the mean PSNR and SSIM over the held-out views. Not a test: a witness that
the two trainers follow the same trajectory on a capture (distorted,
masked, basic). Run one process per side, e.g. on
``tools/make_synthetic_dataset.py SCENE --scene distorted --hw 64
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
        target, name = (config.datamanager, k.split(".", 1)[1]) if k.startswith("datamanager.") else (config.model, k)
        setattr(target, name, type(getattr(target, name))(v))
    return config


def run_jax(scene, steps, every, fields):
    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_tpu.pipelines.factory import build_trainer

    config = _configure(get_method("nerfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    trainer = build_trainer(config, use_mesh=False)
    t0 = time.time()
    for step in range(steps):
        trainer.train_iteration(step)
        if (step + 1) % every == 0:
            m = trainer.pipeline.get_average_eval_image_metrics(trainer.state)
            yield dict(step=step + 1, psnr=m["psnr"], ssim=m["ssim"], seconds=time.time() - t0)


def run_torch(scene, steps, every, fields):
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.pipelines.factory import build_trainer

    config = _configure(get_method("nerfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    config.machine.device_type = "cpu"
    trainer = build_trainer(config)
    t0 = time.time()
    for step in range(steps):
        trainer.train_iteration(step)
        if (step + 1) % every == 0:
            m = trainer.pipeline.get_average_eval_image_metrics(trainer.state)
            yield dict(step=step + 1, psnr=m["psnr"], ssim=m["ssim"], seconds=time.time() - t0)


def main(argv):
    scene, steps, every, side = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    fields = dict(a.split("=", 1) for a in argv[4:])
    for rec in (run_jax if side == "jax" else run_torch)(scene, steps, every, fields):
        print(json.dumps(dict(side=side, scene=scene.name, **rec)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
