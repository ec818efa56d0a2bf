"""Per-group Adam and RAdam (counterpart of
``nerfstudio_tpu/engine/optimizers.py``), and splatfacto's per-array Adam
(``SplatAdam``, counterpart of
``nerfstudio_tpu/pipelines/splat_pipeline.py:build_splat_optimizers``).

The reference builds one optax ``multi_transform`` whose labels come from
the top-level modules of the param tree; here each group is one
``torch.optim.Adam`` (or ``RAdam``, optax's rectified Adam) over the
parameters of the top-level modules whose names start with the group's
name. Three properties of optax are kept:

* a parameter with no gradient (``.grad is None``, e.g. a frozen proposal
  net) is stepped on a zero gradient, so its moments decay and its Adam
  step count stays the group's;
* the learning rate follows the optimizer's own step count (optax's
  ``scale_by_schedule``), not the trainer's step; a group without a
  schedule keeps its rate;
* ``reset`` is a fresh ``init``: every moment and every count back to 0
  (TensoRF's upsampling re-initialises its optimizer so).

Gradient clipping, weight decay and gradient accumulation are not ported."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.engine.schedulers import (
    CosineDecaySchedulerConfig,
    ExponentialDecaySchedulerConfig,
    MultiStepSchedulerConfig,
)


@dataclasses.dataclass
class AdamOptimizerConfig:
    """(reference optimizers.py:37-55), without clipping and weight decay."""

    lr: float = 5e-4
    eps: float = 1e-8
    betas: tuple = (0.9, 0.999)


@dataclasses.dataclass
class RAdamOptimizerConfig:
    """(reference optimizers.py:58-67), without clipping."""

    lr: float = 5e-4
    eps: float = 1e-8
    betas: tuple = (0.9, 0.999)


class RAdam(torch.optim.Optimizer):
    """``optax.radam`` (``scale_by_radam`` then the learning rate), not
    ``torch.optim.RAdam``, which places ``eps`` and the rectification
    otherwise. Per parameter, at count t after the increment: the moments
    m = (1 - b1) g + b1 m and v = (1 - b2) g^2 + b2 v, their bias-corrected
    m^ and v^, and rho_t = rho_inf - 2 t b2^t / (1 - b2^t) with rho_inf =
    2 / (1 - b2) - 1; the update is r m^ / (sqrt(v^) + eps), r the
    rectification, where rho_t >= 5 (optax's threshold), else m^ alone;
    then p += -lr * update. The scalars are float32, computed on the host.
    Every parameter has a gradient (``PerGroupAdam.step`` fills zeros)."""

    THRESHOLD = 5.0

    def __init__(self, params, lr: float = 5e-4, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @staticmethod
    def scalars(t: int, b1: float, b2: float) -> Tuple[float, float, Optional[float]]:
        """(1 - b1^t, 1 - b2^t, r or None below the threshold), in float32."""
        f32 = np.float32
        b2t = f32(b2) ** f32(t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
        r = None
        if ro >= RAdam.THRESHOLD:
            r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        return float(f32(1) - f32(b1) ** f32(t)), float(f32(1) - b2t), r

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                g = p.grad
                st = self.state[p]
                if not st:
                    st.update(step=0, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * (g * g) + b2 * v)
                bc1, bc2, r = self.scalars(st["step"], b1, b2)
                update = m / bc1
                if r is not None:
                    update = r * update / (torch.sqrt(v / bc2) + group["eps"])
                p.add_(update * -group["lr"])


def nerfacto_optimizers(max_steps: int = 30000) -> Dict[str, Dict[str, Any]]:
    """nerfacto's groups (reference configs/method_configs.py:75-89)."""
    return {
        "field": {
            "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
            "scheduler": ExponentialDecaySchedulerConfig(lr_final=1e-4, max_steps=max_steps),
        },
        "proposal_networks": {
            "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
            "scheduler": ExponentialDecaySchedulerConfig(lr_final=1e-4, max_steps=max_steps),
        },
        "camera_optimizer": {
            "optimizer": AdamOptimizerConfig(lr=6e-4, eps=1e-15),
            "scheduler": ExponentialDecaySchedulerConfig(lr_final=6e-6, max_steps=max_steps),
        },
    }


def neus_optimizers() -> Dict[str, Dict[str, Any]]:
    """plain neus's one group (reference configs/method_configs.py:327-339):
    the SDF field at Adam's default eps, a cosine decay over 300,000 steps
    after a 5000-step warm-up."""
    return {
        "field": {
            "optimizer": AdamOptimizerConfig(lr=5e-4),
            "scheduler": CosineDecaySchedulerConfig(warm_up_end=5000, max_steps=300000),
        },
    }


def neus_facto_optimizers(max_steps: int = 20000) -> Dict[str, Dict[str, Any]]:
    """neus-facto's groups (reference configs/method_configs.py:341-357): the
    SDF field with a cosine decay after a 500-step warm-up, the proposal
    nets at a multi-step rate whose milestones lie past ``max_steps``."""
    return {
        "field": {
            "optimizer": AdamOptimizerConfig(lr=5e-4, eps=1e-15),
            "scheduler": CosineDecaySchedulerConfig(warm_up_end=500, max_steps=max_steps),
        },
        "proposal_networks": {
            "optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
            "scheduler": MultiStepSchedulerConfig(),
        },
    }


def group_parameters(model: torch.nn.Module, group_names) -> Dict[str, List[torch.nn.Parameter]]:
    """Parameters per group: a top-level module belongs to the longest group
    name it starts with (reference optimizers.py:91-105); a parameter that
    matches none raises."""
    groups = sorted(group_names, key=len, reverse=True)
    out: Dict[str, List[torch.nn.Parameter]] = {g: [] for g in group_names}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        match = next((g for g in groups if top.startswith(g)), None)
        if match is None:
            raise ValueError(f"no optimizer group for parameter {name}; groups: {list(group_names)}")
        out[match].append(p)
    return out


class PerGroupAdam:
    """One Adam (or RAdam) per group, stepped together (reference
    ``build_optimizers``)."""

    def __init__(self, optimizer_configs: Dict[str, Dict[str, Any]], model: torch.nn.Module):
        """``optimizer_configs``: {group: {"optimizer": AdamOptimizerConfig or
        RAdamOptimizerConfig, "scheduler": a scheduler config or None (a
        constant rate)}}. A group without parameters (vanilla-nerf's
        ``temporal_distortion`` while the distortion is off) steps nothing."""
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}
        self.schedules = {}
        for group, params in group_parameters(model, optimizer_configs).items():
            if not params:  # e.g. the camera optimizer with mode "off"
                continue
            cfg = optimizer_configs[group]["optimizer"]
            sched = optimizer_configs[group].get("scheduler")
            self.schedules[group] = (lambda count, lr=cfg.lr: lr) if sched is None else sched.build(cfg.lr)
            kind = RAdam if isinstance(cfg, RAdamOptimizerConfig) else torch.optim.Adam
            self.optimizers[group] = kind(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps)
        self.count = 0  # updates applied so far, the schedules' index

    def reset(self) -> None:
        """Every moment and count back to 0, as a fresh optax ``init``."""
        for opt in self.optimizers.values():
            opt.state.clear()
        self.count = 0

    def learning_rates(self) -> Dict[str, float]:
        """The rates the next ``step`` applies."""
        return {g: s(self.count) for g, s in self.schedules.items()}

    def zero_grad(self) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group, opt in self.optimizers.items():
            for pg in opt.param_groups:
                for p in pg["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                pg["lr"] = self.schedules[group](self.count)
            opt.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """Every group's Adam moments and step counts, and the schedules' count."""
        return {"count": self.count, "optimizers": {g: opt.state_dict() for g, opt in self.optimizers.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if set(state["optimizers"]) != set(self.optimizers):
            raise ValueError(f"optimizer groups {sorted(state['optimizers'])} vs {sorted(self.optimizers)}")
        for g, opt in self.optimizers.items():
            opt.load_state_dict(state["optimizers"][g])
        self.count = int(state["count"])


# splatfacto's constant rates (reference pipelines/splat_pipeline.py:50-65),
# the per-image bilateral grids and camera-opt tangents included; ``means``
# follows ``splat_means_lr``.
SPLAT_LRS = {
    "features_dc": 0.0025,
    "features_rest": 0.0025 / 20,
    "opacities": 0.05,
    "scales": 0.005,
    "quats": 0.001,
    "bilateral_grids": 5e-3,
    "camera_opt": 1e-4,
}


def splat_means_lr(count: int, max_steps: int = 30000) -> float:
    """1.6e-4 decaying exponentially to 1.6e-6 over ``max_steps`` (reference
    ``means_lr_schedule``, optax ``exponential_decay``)."""
    return 1.6e-4 * (1.6e-6 / 1.6e-4) ** (count / max_steps)


class SplatAdam:
    """Splatfacto's per-array Adam (reference ``build_splat_optimizers``):
    one ``torch.optim.Adam`` with a param group per array, ``eps=1e-15``,
    the ``means`` rate scheduled by the optimizer's own update count (optax's
    ``scale_by_schedule``). An array without a gradient is stepped on zeros,
    as optax steps it.

    ``zero_rows`` and ``reset`` are the moment surgery of ``refine``: they
    change the moments in place and keep the count, so bias correction still
    uses the group's count. ``zero_rows`` touches only the arrays with one
    row per slot, never the per-image ones, as the reference masks only
    leaves of ``max_gaussians`` rows."""

    def __init__(self, params: Dict[str, torch.Tensor], max_steps: int = 30000):
        unknown = set(params) - set(SPLAT_LRS) - {"means"}
        if unknown:
            raise NotImplementedError(f"no optimizer for {sorted(unknown)}")
        self.params = params
        self.max_steps = max_steps
        self.optimizer = torch.optim.Adam(
            [{"params": [p], "lr": SPLAT_LRS.get(name, 0.0), "name": name} for name, p in params.items()],
            betas=(0.9, 0.999), eps=1e-15,
        )
        self.count = 0  # updates applied so far, the schedule's index

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for pg in self.optimizer.param_groups:
            p = pg["params"][0]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if pg["name"] == "means":
                pg["lr"] = splat_means_lr(self.count, self.max_steps)
        self.optimizer.step()
        self.count += 1

    def _moments(self, name: str):
        state = self.optimizer.state.get(self.params[name])
        return () if not state else (state["exp_avg"], state["exp_avg_sq"])

    @torch.no_grad()
    def zero_rows(self, rows: torch.Tensor) -> None:
        """Zero the moments of each array of N rows on the rows where
        ``rows`` (N,) is true."""
        for name, p in self.params.items():
            if p.shape[0] != rows.shape[0]:
                continue
            for m in self._moments(name):
                m.masked_fill_(rows.view((-1,) + (1,) * (m.ndim - 1)), 0.0)

    @torch.no_grad()
    def reset(self, name: str) -> None:
        """Zero all of one array's moments."""
        for m in self._moments(name):
            m.zero_()

    def state_dict(self) -> Dict[str, Any]:
        """Every array's Adam moments and step count, and the schedule's count."""
        return {"count": self.count, "adam": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        names = [pg["name"] for pg in state["adam"]["param_groups"]]
        if names != list(self.params):
            raise ValueError(f"Adam state for arrays {names}, this optimizer's are {list(self.params)}")
        self.optimizer.load_state_dict(state["adam"])
        self.count = int(state["count"])

    def load_moments(self, moments: Dict[str, Tuple[int, torch.Tensor, torch.Tensor]]) -> None:
        """Set each array's (count, first moment, second moment); every count
        must be the same."""
        counts = {int(c) for c, _, _ in moments.values()}
        if set(moments) != set(self.params) or len(counts) != 1:
            raise ValueError(f"moments for {sorted(moments)} with counts {sorted(counts)}, "
                             f"arrays {sorted(self.params)}")
        for name, (count, mu, nu) in moments.items():
            p = self.params[name]
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu.to(p.device, torch.float32).clone(),
                "exp_avg_sq": nu.to(p.device, torch.float32).clone(),
            }
        self.count = counts.pop()
