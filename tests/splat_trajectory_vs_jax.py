"""splatfacto's quality trajectory, JAX package against the port, on the CPU:

    JAX_PLATFORMS=cpu python tests/splat_trajectory_vs_jax.py SCENE STEPS EVERY {jax,torch} [field=value ...]

Each side builds splatfacto from its own method config on the scene (the
nerfstudio parser at ``train_split_fraction=0.9``, the seed points), sets
the model fields given as ``field=value`` (the same on both sides), trains
with its own generator (the camera order is the same seeded permutation on
both; the random backgrounds and the refine's draws are each side's own)
and prints, every EVERY steps, one JSON line: the mean PSNR and SSIM over
the held-out views and the live gaussians. Not a test: a witness that the
two trainers follow the same trajectory. Run one process per side, e.g. on
``tools/make_synthetic_dataset.py SCENE --hw 64 --n-train 16 --n-test 4
--n-points 2000``."""

import json
import sys
import time
from pathlib import Path

import numpy as np


def _configure(config, parser_cls, scene: Path, steps: int, fields: dict):
    config.data = scene
    config.dataparser = parser_cls(data=scene, train_split_fraction=0.9, downscale_factor=1, load_3D_points=True)
    config.trainer.max_num_iterations = steps
    for k, v in fields.items():
        setattr(config.model, k, type(getattr(config.model, k))(v))
    return config


def run_jax(scene, steps, every, fields):
    import jax

    from nerfstudio_tpu.configs.method_configs import get_method
    from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_tpu.pipelines.splat_pipeline import build_splat_pipeline

    config = _configure(get_method("splatfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    pipe, state = build_splat_pipeline(config, use_mesh=False)
    key = jax.random.PRNGKey(config.seed)
    t0 = time.time()
    for end in range(every, steps + 1, every):
        key, k = jax.random.split(key)
        state = pipe.train(state, end, k)
        ms = [pipe.get_eval_image_metrics(state, i)[0] for i in range(len(pipe.datamanager.eval_dataset))]
        yield dict(step=end, psnr=float(np.mean([m["psnr"] for m in ms])),
                   ssim=float(np.mean([m["ssim"] for m in ms])), alive=int(np.asarray(state.aux.alive).sum()),
                   seconds=time.time() - t0)


def run_torch(scene, steps, every, fields):
    import torch

    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline

    config = _configure(get_method("splatfacto"), NerfstudioDataParserConfig, scene, steps, fields)
    config.machine.device_type = "cpu"
    pipe, state = build_splat_pipeline(config)
    gen = torch.Generator().manual_seed(config.seed)
    t0 = time.time()
    for end in range(every, steps + 1, every):
        state, _ = pipe.train(state, end, gen)
        m = pipe.get_average_eval_image_metrics(state)
        yield dict(step=end, psnr=m["psnr"], ssim=m["ssim"], alive=int(state.aux.alive.sum()),
                   seconds=time.time() - t0)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 4:
        print(__doc__)
        return
    scene, steps, every, side = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    fields = dict(a.split("=", 1) for a in argv[4:])
    for rec in (run_jax if side == "jax" else run_torch)(scene, steps, every, fields):
        print(json.dumps(dict(side=side, **rec)), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main()
