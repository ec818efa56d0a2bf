"""Data-parallel training over ranks (counterpart of
``nerfstudio_tpu/parallel/mesh.py``).

The reference's mesh has one ``data`` axis: the parameters replicated, the
global ray batch sharded on it, and XLA's psum for the gradient. Here each
rank is a process (``launch``). Every rank draws the same global batch from
the same generator (no rank offset, unlike upstream nerfstudio's per-rank
batches) and keeps its contiguous slice (``shard_rays``); the model's own
per-ray draws take the global batch's draw and the rank's slice the same
way inside ``ray_shard``. One ``all_reduce`` of the flattened gradients
(``all_reduce_grads``) then gives every rank the gradient of the global
batch's mean loss, so every rank's optimizer takes the one-rank step and
the replicas stay bit-equal.

``torch.distributed`` is used directly, not ``DistributedDataParallel``:
the splat parameters are a dict of tensors, not a module, and nerfacto
leaves parameters without a gradient on its frozen-proposal steps, which
DDP's wrapper refuses. The collectives are NCCL's (on the card) or gloo's
(on the CPU, or through host memory for CUDA tensors), outside any kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import socket
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# (world size, rank) of the ray batch the model's draws are a shard of,
# inside ``ray_shard``; None outside
_RAY_SHARD: contextvars.ContextVar = contextvars.ContextVar("ray_shard", default=None)


def is_initialized() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of the process group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """Rank-0 gating (reference utils/comms.py ``is_main_process``)."""
    return rank() == 0


def local_device_count() -> int:
    """The CUDA devices this machine has."""
    return torch.cuda.device_count()


def barrier() -> None:
    """Every rank waits for the others (nothing without a process group)."""
    if is_initialized():
        dist.barrier()


def shard_rays(tree, world: Optional[int] = None, r: Optional[int] = None):
    """This rank's contiguous slice of the leading (ray) axis of every
    tensor in ``tree`` (a tensor, None, or a dict, list, tuple or dataclass
    of them): rows ``[r * n / W, (r + 1) * n / W)``. ``world`` and ``r``
    default to the process group's. The ray count must divide by the
    world size: unequal shards would weigh a rank's mean loss by its share."""
    world = world_size() if world is None else world
    r = rank() if r is None else r
    if world == 1:
        return tree

    def cut(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            n = x.shape[0]
            if n % world:
                raise ValueError(f"a batch of {n} rays does not split evenly over {world} ranks")
            k = n // world
            return x[r * k:(r + 1) * k]
        if isinstance(x, dict):
            return {key: cut(v) for key, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})
        raise TypeError(f"cannot shard a {type(x).__name__}")

    return cut(tree)


@contextlib.contextmanager
def ray_shard():
    """Inside the block, ``rand_rays`` draws the global batch's uniforms and
    returns this rank's slice of them. The train step runs the model's
    forward inside it."""
    token = _RAY_SHARD.set((world_size(), rank()))
    try:
        yield
    finally:
        _RAY_SHARD.reset(token)


def rand_rays(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``torch.rand(shape)`` for a draw whose leading axis is the rays (a
    sampler's jitter, a random background). Inside ``ray_shard`` of W ranks
    it draws ``W`` times the rays, as one rank holding the global batch
    would, and returns rank r's rows: every rank consumes the generator as
    the one-rank step does, and the ranks' draws together are its draw."""
    shard = _RAY_SHARD.get()
    if shard is None or shard[0] == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    world, r = shard
    n = shape[0]
    full = torch.rand((n * world,) + tuple(shape[1:]), generator=generator, device=device)
    return full[r * n:(r + 1) * n]


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Every parameter's ``.grad`` replaced by its mean over the ranks, with
    one ``all_reduce`` (SUM, then a division by the world size) of one
    buffer per dtype that holds every gradient flattened. A parameter
    without a gradient on a rank takes part as zeros, so that every rank
    makes the same collective; one flag per parameter rides in the first
    buffer, and a parameter no rank has a gradient for keeps ``.grad``
    None (the optimizer then steps it as the one-rank step does). Nothing
    without a process group (a group of one rank sums one term and
    divides by 1: every gradient as it was)."""
    if not is_initialized():
        return
    world = world_size()
    params = list(params)
    groups: Dict[torch.dtype, list] = {}
    for i, p in enumerate(params):
        groups.setdefault(p.dtype, []).append(i)
    flags_dtype = next(iter(groups))
    flags = []
    for dtype, idx in groups.items():
        dev = params[idx[0]].device
        parts = [params[i].grad.reshape(-1) if params[i].grad is not None
                 else torch.zeros(params[i].numel(), dtype=dtype, device=dev) for i in idx]
        if dtype == flags_dtype:
            parts.append(torch.tensor([float(p.grad is not None) for p in params], dtype=dtype, device=dev))
        buf = torch.cat(parts)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        buf.div_(world)
        if dtype == flags_dtype:
            flags = buf[-len(params):].tolist()
        offset = 0
        for i in idx:
            p, n = params[i], params[i].numel()
            g = buf[offset:offset + n].view_as(p)
            offset += n
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
    for i, p in enumerate(params):
        if flags[i] == 0.0:
            p.grad = None


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks in place (``op`` "sum" or "max"), and
    returned; nothing without a process group."""
    if is_initialized():
        dist.all_reduce(t, op=_OPS[op])
    return t


def global_means(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the ranks, with one ``all_reduce`` (gloo has
    no AVG: SUM, then a division); the values as they are without a
    process group."""
    if not is_initialized() or not values:
        return values
    world = world_size()
    keys = list(values)
    buf = torch.stack([values[k].detach().to(torch.float32).reshape(()) for k in keys])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    buf.div_(world)
    return dict(zip(keys, buf.unbind()))


# --------------------------------------------------------------------------
# launching


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn: Callable, args: Sequence = (), *, devices: Sequence[str], backend: str, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto", timeout_s: float = 1800.0) -> None:
    """Run ``fn(*args)`` on every local rank of a world of ``num_machines
    x len(devices)`` ranks (reference scripts/train.py ``launch``). Local
    rank i runs on ``devices[i]`` (made the current CUDA device there) with
    global rank ``machine_rank * len(devices) + i``, in a process of its own
    started with the ``spawn`` method (in this process where this machine
    has one rank), after ``init_process_group(backend, dist_url)``.
    ``dist_url`` "auto" takes a free localhost port (one machine only);
    ``tcp://HOST:PORT`` and ``file://PATH`` are used as given. Each spawned
    rank takes its share of this process's torch threads. With a world of
    one rank ``fn`` runs here with no process group. The caller chooses the
    backend and the devices; nothing here changes them."""
    num_devices = len(devices)
    world = num_machines * num_devices
    if num_devices < 1 or not 0 <= machine_rank < num_machines:
        raise ValueError(f"{num_devices} devices, machine {machine_rank} of {num_machines}")
    if world == 1:
        fn(*args)
        return
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("dist_url 'auto' finds a port on this machine: give tcp://HOST:PORT for several")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    common = (fn, tuple(args), list(devices), backend, world, machine_rank, dist_url, timeout_s)
    if num_devices == 1:
        _rank_main(0, *common, None)
        return
    threads = max(1, torch.get_num_threads() // num_devices)
    torch.multiprocessing.start_processes(_rank_main, args=common + (threads,), nprocs=num_devices, join=True,
                                          start_method="spawn")


def _rank_main(local_rank: int, fn: Callable, args: tuple, devices: list, backend: str, world: int,
               machine_rank: int, dist_url: str, timeout_s: float, threads: Optional[int]) -> None:
    """One rank: its threads and device, the process group, ``fn``."""
    if threads is not None:
        torch.set_num_threads(threads)
    device = torch.device(devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=dist_url, world_size=world,
                            rank=machine_rank * len(devices) + local_rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()
