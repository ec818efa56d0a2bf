"""Learning-rate schedules (counterpart of
``nerfstudio_tpu/engine/schedulers.py``): the exponential decay nerfacto
ships, and neus-facto's cosine decay and multi-step. A schedule is a
function of the optimizer's own step count, as optax indexes it
(``optax.scale_by_schedule``), not of the trainer's step. Evaluated on the
host in float32, as the reference's ``jnp`` schedules are."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

Schedule = Callable[[int], float]


@dataclasses.dataclass
class ExponentialDecaySchedulerConfig:
    """Log-space exponential decay from ``lr_init`` to ``lr_final`` over
    ``max_steps`` (reference :35-60); the reference's warm-up ramp is not
    ported (nerfacto's config has no warm-up)."""

    lr_final: Optional[float] = None
    max_steps: int = 100000

    def build(self, lr_init: float) -> Schedule:
        f32 = np.float32
        lr0 = f32(lr_init)
        lr1 = f32(self.lr_final if self.lr_final is not None else lr_init)
        mx = f32(max(self.max_steps, 1))

        def schedule(count: int) -> float:
            t = np.clip(f32(count) / mx, f32(0), f32(1))
            return float(np.exp(np.log(lr0) * (f32(1) - t) + np.log(lr1) * t))

        return schedule


@dataclasses.dataclass
class MultiStepSchedulerConfig:
    """``lr_init`` times ``gamma`` for each milestone the count has reached
    (reference :19-31, ``optax.piecewise_constant_schedule``; the
    reference's ``max_steps`` field is read by nothing and not kept)."""

    gamma: float = 0.33
    milestones: Tuple[int, ...] = (500000, 750000, 900000)

    def build(self, lr_init: float) -> Schedule:
        f32 = np.float32

        def schedule(count: int) -> float:
            lr = f32(lr_init)
            for m in self.milestones:
                if count >= m:
                    lr = lr * f32(self.gamma)
            return float(lr)

        return schedule


@dataclasses.dataclass
class CosineDecaySchedulerConfig:
    """Linear warm-up to ``lr_init`` over ``warm_up_end`` steps, then a
    cosine to ``learning_rate_alpha * lr_init`` at ``max_steps`` (reference
    :64-83)."""

    warm_up_end: int = 5000
    learning_rate_alpha: float = 0.05
    max_steps: int = 300000

    def build(self, lr_init: float) -> Schedule:
        f32 = np.float32
        alpha, warm, mx = f32(self.learning_rate_alpha), self.warm_up_end, self.max_steps

        def schedule(count: int) -> float:
            step = f32(count)
            if count < warm:
                factor = np.clip(step / f32(max(warm, 1)), f32(0), f32(1))
            else:
                progress = np.clip((step - f32(warm)) / f32(max(mx - warm, 1)), f32(0), f32(1))
                cos = (np.cos(f32(np.pi) * progress) + f32(1)) * f32(0.5)
                factor = (f32(1) - alpha) * cos + alpha
            return float(f32(lr_init) * factor)

        return schedule
