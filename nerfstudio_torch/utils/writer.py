"""Event writer (counterpart of ``nerfstudio_tpu/utils/writer.py``):
scalars to stdout and to ``scalars.jsonl`` in the run directory, one JSON
object per (prefix, step). TensorBoard (tensorboardX) and wandb are used
only where they import, as the reference gates them. In a process group
only rank 0 writes (``utils.decorators.check_main_thread``)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np

from nerfstudio_torch.utils.decorators import check_main_thread

SCALARS_FILE = "scalars.jsonl"


class EventWriter:
    """(reference writer.py:16-126)"""

    def __init__(self, log_dir: Path, vis: str = "tensorboard"):
        self.log_dir = Path(log_dir)
        self.vis = vis
        self._tb = None
        self._wandb = None
        self._last_print: Dict[str, float] = {}
        self._open_backends(vis)

    @check_main_thread
    def _open_backends(self, vis: str) -> None:
        if "tensorboard" in vis:
            try:
                from tensorboardX import SummaryWriter

                self.log_dir.mkdir(parents=True, exist_ok=True)
                self._tb = SummaryWriter(logdir=str(self.log_dir), flush_secs=2)
            except ImportError:
                pass
        if "wandb" in vis:
            try:
                import wandb

                wandb.init(dir=str(self.log_dir), project="nerfstudio-torch")
                self._wandb = wandb
            except ImportError:
                pass

    @check_main_thread
    def put_dict(self, prefix: str, values: Dict[str, float], step: int) -> None:
        """Scalars of one step under ``prefix``: appended to the scalars
        file, sent to TensorBoard/wandb where on, printed at most every 2 s
        per prefix."""
        values = {k: float(v) for k, v in values.items()}
        self.log_dir.mkdir(parents=True, exist_ok=True)
        with open(self.log_dir / SCALARS_FILE, "a", encoding="utf-8") as f:
            f.write(json.dumps({"prefix": prefix, "step": step, "time": time.time(), **values}) + "\n")
        for k, v in values.items():
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
            if self._wandb is not None:
                self._wandb.log({f"{prefix}/{k}": v}, step=step)
        now = time.time()
        if now - self._last_print.get(prefix, 0.0) > 2.0:
            self._last_print[prefix] = now
            print(f"[{prefix} {step}] " + " ".join(f"{k}={v:.4g}" for k, v in values.items()), flush=True)

    @check_main_thread
    def put_image(self, name: str, image, step: int) -> None:
        if self._tb is None and self._wandb is None:
            return
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_image(name, img, step, dataformats="HWC")
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(img)}, step=step)

    @check_main_thread
    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
