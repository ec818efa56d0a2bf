"""Machine config (counterpart of ``nerfstudio_tpu/configs/base_config.py``);
the CLI (``configs/cli.py``) turns a dataclass tree into dotted flags."""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from nerfstudio_torch.utils.device import resolve_device


@dataclasses.dataclass
class MachineConfig:
    """(reference base_config.py:25-35) with upstream nerfstudio's
    ``device_type``: the entry points run on ``cuda`` unless it names the
    CPU, and ``cuda`` without a card raises. The seed is the method
    config's ``seed``; the reference's unread ``machine.seed`` is left out,
    so ``--machine.seed`` is refused as an unknown flag."""

    num_devices: Optional[int] = None
    num_machines: int = 1
    machine_rank: int = 0
    dist_url: str = "auto"
    device_type: Literal["cpu", "cuda"] = "cuda"

    def device(self) -> torch.device:
        if self.num_devices not in (None, 1) or self.num_machines != 1:
            raise NotImplementedError("training on more than one device is not ported (ROADMAP queue 1 item 17)")
        return resolve_device(self.device_type)
