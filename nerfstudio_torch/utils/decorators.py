"""Execution-gating decorators (counterpart of
``nerfstudio_tpu/utils/decorators.py``; reference
nerfstudio/utils/decorators.py:30-86): writers, checkpoints and the viewer
run on the main process only, and on objects that have them enabled."""

from __future__ import annotations

import functools
from typing import Callable


def check_main_thread(fn: Callable) -> Callable:
    """Run only on the main process (reference decorators.py:46-56): rank 0
    of ``torch.distributed`` where a process group is initialised, else
    always."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapper


def check_viewer_enabled(fn: Callable) -> Callable:
    """Run only when the object's viewer exists (reference :59-71)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if getattr(self, "viewer", None) is not None:
            return fn(self, *args, **kwargs)
        return None

    return wrapper


def check_eval_enabled(fn: Callable) -> Callable:
    """Run only when an eval cadence is configured (reference :74-86)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        cfg = getattr(self, "config", None)
        if cfg is not None and (
            getattr(cfg, "steps_per_eval_image", 0)
            or getattr(cfg, "steps_per_eval_batch", 0)
            or getattr(cfg, "steps_per_eval_all_images", 0)
        ):
            return fn(self, *args, **kwargs)
        return None

    return wrapper
