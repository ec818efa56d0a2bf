"""Trainer (counterpart of ``nerfstudio_tpu/engine/trainer.py``).

The loop around the pipeline's train step: each step the model's
``step_kwargs`` and auxiliary hook (nerfacto's occupancy update), then one
train step; the eval cadences (a batch of eval rays, one eval image, every
eval image), rays/s to the writer, and checkpoints.

A checkpoint is one ``torch.save`` file per step,
``<checkpoint dir>/step-<step>.ckpt``: the model's state dict, every Adam
moment and count, the auxiliary state, the step and the state of the
trainer's generator, so a resumed run continues bit-equal to one that never
stopped. ``save_only_latest_checkpoint`` deletes the older files."""

from __future__ import annotations

import dataclasses
import os
import re
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.utils import writer as writer_lib

_CHECKPOINT = re.compile(r"step-(\d+)\.ckpt")


@dataclasses.dataclass
class TrainerConfig:
    """(reference engine/trainer.py:25-52): the same fields and defaults."""

    method_name: str = "base"
    experiment_name: Optional[str] = None
    output_dir: Path = Path("outputs")
    timestamp: str = "{timestamp}"
    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 25000
    save_only_latest_checkpoint: bool = True
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    log_gradients: bool = False
    vis: str = "tensorboard"

    def get_base_dir(self) -> Path:
        exp = self.experiment_name or "unnamed"
        ts = self.timestamp
        if ts == "{timestamp}":
            ts = time.strftime("%Y-%m-%d_%H%M%S")
        return Path(self.output_dir) / exp / self.method_name / ts

    def get_checkpoint_dir(self, base_dir: Path) -> Path:
        return base_dir / "nerfstudio_models"


# --------------------------------------------------------------------------
# checkpoint files, shared with the splat pipeline


def checkpoint_steps(ckpt_dir: Path) -> list:
    """The steps of the checkpoints in ``ckpt_dir``, ascending."""
    if not Path(ckpt_dir).is_dir():
        return []
    return sorted(int(m[1]) for p in Path(ckpt_dir).iterdir() if (m := _CHECKPOINT.fullmatch(p.name)))


def write_checkpoint(ckpt_dir: Path, step: int, payload: Dict[str, Any], only_latest: bool = False) -> Path:
    """``payload`` to ``step-<step>.ckpt`` (written to a temporary name, then
    renamed); with ``only_latest`` the other steps' files are deleted."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step-{step:09d}.ckpt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if only_latest:
        for s in checkpoint_steps(ckpt_dir):
            if s != step:
                (ckpt_dir / f"step-{s:09d}.ckpt").unlink()
    return path


def read_checkpoint(ckpt_dir: Path, step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
    """(step, payload) of the checkpoint at ``step`` (None: the latest)."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        step = steps[-1]
    path = Path(ckpt_dir) / f"step-{step:09d}.ckpt"
    return step, torch.load(path, map_location="cpu", weights_only=True)


def aux_state(aux) -> Optional[Dict[str, Any]]:
    """A dataclass of tensors (the occupancy grid, the splat aux) as a dict."""
    return None if aux is None else {f.name: getattr(aux, f.name) for f in dataclasses.fields(aux)}


def aux_from_state(template, saved: Optional[Dict[str, Any]], device):
    """``saved`` (from ``aux_state``) as ``template``'s type on ``device``."""
    if saved is None:
        return None
    return type(template)(**{k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in saved.items()})


def restore_train_state(pipeline, state, payload: Dict[str, Any]) -> None:
    """A ray-based pipeline's model and ``state`` (optimizer, aux, step)
    from a checkpoint's payload, in place."""
    pipeline.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.aux = aux_from_state(state.aux, payload["aux"], pipeline.device)
    state.step = int(payload["step"])


# --------------------------------------------------------------------------


class Trainer:
    """(reference engine/trainer.py:55-290). ``state`` is the pipeline's
    ``TrainState``; ``step_kwargs_fn(step)`` gives the model's per-step
    arguments. The random draws of every step come from one generator on
    the pipeline's device, seeded from ``seed``."""

    def __init__(self, config: TrainerConfig, pipeline, state, step_kwargs_fn: Optional[Callable] = None,
                 seed: int = 42):
        self.config = config
        self.pipeline = pipeline
        self.state = state
        self.step_kwargs_fn = step_kwargs_fn or (lambda step: {})
        self.base_dir = config.get_base_dir()
        self.checkpoint_dir = config.get_checkpoint_dir(self.base_dir)
        self.generator = torch.Generator(device=pipeline.device).manual_seed(seed)
        self.writer = writer_lib.EventWriter(self.base_dir, vis=config.vis)

    # ------------------------------------------------------------------
    def checkpoint(self) -> Dict[str, Any]:
        return {"step": self.state.step, "model": self.pipeline.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(), "aux": aux_state(self.state.aux),
                "generator": self.generator.get_state()}

    def save_checkpoint(self, step: int) -> None:
        """(reference trainer.py:99-115)"""
        write_checkpoint(self.checkpoint_dir, step, self.checkpoint(), self.config.save_only_latest_checkpoint)

    def load_checkpoint(self) -> None:
        """Resume from ``load_dir`` at ``load_step`` (None: the latest)
        (reference trainer.py:117-152)."""
        step, payload = read_checkpoint(self.config.load_dir, self.config.load_step)
        restore_train_state(self.pipeline, self.state, payload)
        self.generator.set_state(payload["generator"])
        print(f"loaded checkpoint at step {step} from {self.config.load_dir}", flush=True)

    # ------------------------------------------------------------------
    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        """(reference trainer.py:165-180): the resident images' reload on its
        cadence, the auxiliary hook, then one step."""
        kwargs = self.step_kwargs_fn(step)
        self.pipeline.datamanager.maybe_reload(step)
        if self.pipeline.aux_update_fn is not None:
            self.pipeline.aux_update_fn(self.state, step, self.generator)
        return self.pipeline.train_step(self.state, self.generator, **kwargs)

    def train(self) -> None:
        """The main loop (reference trainer.py:174-238)."""
        cfg = self.config
        num_rays = self.pipeline.datamanager.config.train_num_rays_per_batch
        self.base_dir.mkdir(parents=True, exist_ok=True)
        t_last = time.perf_counter()
        steps_since_log = 0
        for step in range(int(self.state.step), cfg.max_num_iterations):
            metrics = self.train_iteration(step)
            steps_since_log += 1
            if step % 10 == 0 or step == cfg.max_num_iterations - 1:
                host_metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                now = time.perf_counter()
                host_metrics["train_rays_per_sec"] = num_rays * steps_since_log / (now - t_last)
                t_last, steps_since_log = now, 0
                self.writer.put_dict("train", host_metrics, step)
            if cfg.steps_per_eval_batch and step % cfg.steps_per_eval_batch == 0 and step > 0:
                self.eval_batch_iteration(step)
            if cfg.steps_per_eval_image and step % cfg.steps_per_eval_image == 0 and step > 0:
                self.eval_iteration(step)
            if cfg.steps_per_eval_all_images and step % cfg.steps_per_eval_all_images == 0 and step > 0:
                self.writer.put_dict("eval_all", self.pipeline.get_average_eval_image_metrics(self.state), step)
            if cfg.steps_per_save and (step + 1) % cfg.steps_per_save == 0:
                self.save_checkpoint(step + 1)
        self.save_checkpoint(cfg.max_num_iterations)
        self.writer.flush()
        print(f"training finished; checkpoints in {self.checkpoint_dir}", flush=True)

    def eval_batch_iteration(self, step: int) -> Dict[str, float]:
        """PSNR of 1024 random pixels of a random eval image, both drawn from
        ``np.random.default_rng(step)`` (reference trainer.py:240-270)."""
        from nerfstudio_torch.model_components.ray_generators import generate_rays_from_indices
        from nerfstudio_torch.utils.metrics import psnr

        dm = self.pipeline.datamanager
        rng = np.random.default_rng(step)
        img_idx = int(rng.integers(len(dm.eval_dataset)))
        gt = dm.eval_dataset.get_image_float32(img_idx)
        h, w = gt.shape[:2]
        n_rays = min(dm.config.eval_num_rays_per_batch, 1024)
        rows, cols = rng.integers(0, h, n_rays), rng.integers(0, w, n_rays)
        idx = torch.from_numpy(np.stack([np.full(n_rays, img_idx), rows, cols], axis=-1)).to(self.pipeline.device)
        out = self.pipeline.eval_rays(self.state, generate_rays_from_indices(dm.eval_cameras, idx))
        gt_px = torch.from_numpy(np.ascontiguousarray(gt[rows, cols])).to(self.pipeline.device)
        metrics = {"eval_batch_psnr": float(psnr(out["rgb"], gt_px))}
        self.writer.put_dict("eval_batch", metrics, step)
        return metrics

    def eval_iteration(self, step: int) -> Dict[str, float]:
        """One eval image's metrics (reference trainer.py:272-290)."""
        idx = step % max(len(self.pipeline.datamanager.eval_dataset), 1)
        metrics, images = self.pipeline.get_eval_image_metrics_and_images(self.state, idx)
        self.writer.put_dict("eval", metrics, step)
        self.writer.put_image("eval/img", images["img"], step)
        return metrics
