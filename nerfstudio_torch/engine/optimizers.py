"""Per-group Adam (counterpart of ``nerfstudio_tpu/engine/optimizers.py``).

The reference builds one optax ``multi_transform`` whose labels come from
the top-level modules of the param tree; here each group is one
``torch.optim.Adam`` over the parameters of the top-level modules whose
names start with the group's name. Two properties of optax are kept:

* a parameter with no gradient (``.grad is None``, e.g. a frozen proposal
  net) is stepped on a zero gradient, so its moments decay and its Adam
  step count stays the group's;
* the learning rate follows the optimizer's own step count (optax's
  ``scale_by_schedule``), not the trainer's step.

Gradient clipping, weight decay, RAdam, gradient accumulation and groups
without a schedule are not ported."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from nerfstudio_torch.engine.schedulers import ExponentialDecaySchedulerConfig


@dataclasses.dataclass
class AdamOptimizerConfig:
    """(reference optimizers.py:37-55), without clipping and weight decay."""

    lr: float = 5e-4
    eps: float = 1e-8
    betas: tuple = (0.9, 0.999)


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
    """One Adam per group, stepped together (reference ``build_optimizers``)."""

    def __init__(self, optimizer_configs: Dict[str, Dict[str, Any]], model: torch.nn.Module):
        """``optimizer_configs``: {group: {"optimizer": AdamOptimizerConfig,
        "scheduler": ExponentialDecaySchedulerConfig}}."""
        self.optimizers: Dict[str, torch.optim.Adam] = {}
        self.schedules = {}
        for group, params in group_parameters(model, optimizer_configs).items():
            if not params:  # e.g. the camera optimizer with mode "off"
                continue
            cfg: AdamOptimizerConfig = optimizer_configs[group]["optimizer"]
            self.schedules[group] = optimizer_configs[group]["scheduler"].build(cfg.lr)
            self.optimizers[group] = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps)
        self.count = 0  # updates applied so far, the schedules' index

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
