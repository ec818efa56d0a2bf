"""Learning-rate schedules (counterpart of
``nerfstudio_tpu/engine/schedulers.py``): the exponential decay nerfacto
ships. A schedule is a function of the optimizer's own step count, as
optax indexes it (``optax.scale_by_schedule``), not of the trainer's step.
Evaluated on the host in float32, as the reference's ``jnp`` schedule is;
the other schedules are not ported."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
