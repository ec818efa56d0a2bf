"""Load a saved run for evaluation (counterpart of
``nerfstudio_tpu/utils/eval_utils.py``): the run's ``config.pkl`` and its
latest checkpoint (or ``load_step``'s), on the device its config names."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional


def eval_setup(config_path: Path, load_step: Optional[int] = None):
    """A run directory or its ``config.yml``/``config.pkl`` -> (config,
    pipeline, state), the state restored from the run's checkpoint."""
    config_path = Path(config_path)
    base = config_path if config_path.is_dir() else config_path.parent
    with open(base / "config.pkl", "rb") as f:
        config = pickle.load(f)
    ckpt_dir = config.trainer.get_checkpoint_dir(base)

    from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig

    if isinstance(config.model, SplatfactoModelConfig):
        from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline

        pipeline, state = build_splat_pipeline(config)
        pipeline.load_checkpoint(state, ckpt_dir, load_step)
        return config, pipeline, state

    from nerfstudio_torch.engine.trainer import read_checkpoint, restore_train_state
    from nerfstudio_torch.pipelines.factory import build_pipeline

    pipeline, state, config = build_pipeline(config)
    step, payload = read_checkpoint(ckpt_dir, load_step)
    restore_train_state(pipeline, state, payload)
    print(f"loaded checkpoint at step {step} from {ckpt_dir}", flush=True)
    return config, pipeline, state
