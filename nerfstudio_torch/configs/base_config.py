"""Machine config (counterpart of ``nerfstudio_tpu/configs/base_config.py``);
the CLI (``configs/cli.py``) turns a dataclass tree into dotted flags."""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Optional

import torch

from nerfstudio_torch.parallel import mesh
from nerfstudio_torch.utils.device import resolve_device


@dataclasses.dataclass
class MachineConfig:
    """(reference base_config.py:25-35) with upstream nerfstudio's
    ``device_type``: the entry points run on ``cuda`` unless it names the
    CPU, and ``cuda`` without a card raises. The seed is the method
    config's ``seed``; the reference's unread ``machine.seed`` is left out,
    so ``--machine.seed`` is refused as an unknown flag.

    Training runs on ``num_machines x num_devices`` ranks (upstream
    nerfstudio's ``launch``): global rank ``machine_rank * num_devices +
    local rank``, one card per local rank (``cuda:{local_rank}``, NCCL) or
    one CPU process each (gloo). ``num_devices`` None is every card of the
    machine, as the reference's mesh takes every local device, and one
    process on the CPU. ``dist_url`` "auto" takes a free localhost port (one
    machine); ``tcp://HOST:PORT`` or ``file://PATH`` otherwise."""

    num_devices: Optional[int] = None
    num_machines: int = 1
    machine_rank: int = 0
    dist_url: str = "auto"
    device_type: Literal["cpu", "cuda"] = "cuda"

    def local_devices(self) -> int:
        """The ranks on this machine."""
        if self.num_devices is not None:
            return self.num_devices
        return max(1, mesh.local_device_count()) if self.device_type == "cuda" else 1

    def backend(self) -> str:
        return "nccl" if self.device_type == "cuda" else "gloo"

    def devices(self) -> List[str]:
        """Local rank -> device: ``cuda:{i}``, or the CPU for every rank. A
        card count below ``num_devices`` raises: ranks never share a card."""
        n = self.local_devices()
        if n < 1 or self.num_machines < 1 or not 0 <= self.machine_rank < self.num_machines:
            raise ValueError(f"machine {self.machine_rank} of {self.num_machines} with {n} devices")
        if self.device_type == "cpu":
            return ["cpu"] * n
        have = mesh.local_device_count()
        if n > 1 and n > have:
            raise RuntimeError(f"--machine.num-devices {n} asks for {n} CUDA devices and this machine has {have}")
        return [f"cuda:{i}" for i in range(n)]

    def device(self) -> torch.device:
        """This process's device: in a process group on ``cuda`` the rank's
        card, which ``parallel.mesh.launch`` made the current device; the
        CPU, or ``cuda`` (which must exist) otherwise."""
        if self.device_type == "cuda" and mesh.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        return resolve_device(self.device_type)
