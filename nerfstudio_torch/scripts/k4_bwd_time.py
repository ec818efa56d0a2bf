"""Time K4's backward (``ops/gsplat/projection._project_bwd_kernel``) of
whichever ``nerfstudio_torch`` the interpreter imports, so that two trees
can be compared on one card:

    PYTHONPATH=TREE python nerfstudio_torch/scripts/k4_bwd_time.py --label NAME [--out FILE]

Run it once per tree, in turns (A, B, B, A), in one session on the card.
With ``--parent ROOT`` one process also loads the ``nerfstudio_torch`` under
ROOT (another checkout, its kernels built there) and times its routes in
turns with this tree's, as ``parent_<route>``. The inputs are made on the
card from ``--seed``, so every run times the same numbers: N random
gaussians (100,000 and 1,000,000 by default) in front of a 512^2 pinhole
camera, with random cotangents on the visible ones; or, with ``--inputs
FILE``, one call's saved inputs (``chip_smoke.py --save-k4-inputs FILE``
saves a trained splatfacto-mcmc step's). Each route a tree has is timed,
in turns within the process: ``default`` (the viewmat read on the host,
as the uncorrected training step passes it); where the backward takes
``need_viewmat``, also ``device_viewmat`` (the viewmat read from the card,
no viewmat gradient) and ``viewmat`` (with it). For each: the median of
CUDA events around one call, CUDA events around 50 calls back to back per
call, and the mean profiler record of the backward kernel (plus, for a
tree that sums the viewmat gradient in a second kernel, that kernel's).
One JSON line per input set, with the card's name and power limit, goes
to stdout and is appended to ``--out``."""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import statistics
import subprocess
import sys

import torch


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(fn, calls: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def record_ms(fn, key: str, runs: int = 10) -> float:
    """Mean device ms of the profiler's records whose kernel name holds ``key``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name]
    return sum(spans) / 1e3 / len(spans) if spans else float("nan")


def route_device_ms(fn) -> float:
    """Device ms of one backward call: the backward kernel's mean record, plus
    that of a second kernel summing the viewmat gradient where the tree's
    route launches one (``view_reduce``)."""
    reduce = record_ms(fn, "view_reduce")
    return record_ms(fn, "project_bwd") + (0.0 if math.isnan(reduce) else reduce)


def load_projection(parent=None):
    """(the ``projection`` module of the ``nerfstudio_torch`` on the path,
    that of the one under ``parent`` or None). The parent's modules are
    imported first, its kernel library loaded, and then taken out of
    ``sys.modules``, so each module keeps its own tree's imports."""
    ppj = None
    if parent is not None:
        parent = os.path.abspath(parent)
        sys.path.insert(0, parent)
        from nerfstudio_torch.ops.gsplat import projection as ppj

        if not ppj.__file__.startswith(parent):
            raise SystemExit(f"--parent {parent}: imported {ppj.__file__}")
        ppj._cuda.kernel_library()
        for name in [k for k in sys.modules if k == "nerfstudio_torch" or k.startswith("nerfstudio_torch.")]:
            del sys.modules[name]
        sys.path.remove(parent)
    from nerfstudio_torch.ops.gsplat import projection as pj

    if parent is not None and pj.__file__.startswith(parent):
        raise SystemExit("this tree's nerfstudio_torch is the parent's: put this tree on PYTHONPATH")
    return pj, ppj


def inputs(pj, n: int, seed: int, hw: int = 512):
    """(means, scales, quats, cam_args with the viewmat on the card, cotangents)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device="cuda")  # noqa: E731
    m = (u(n, 3) - 0.5) * 3.0
    s = torch.exp(u(n, 3) * 3.0 - 5.0)
    q = torch.randn((n, 4), generator=gen, device="cuda")
    viewmat = torch.eye(4, device="cuda")
    viewmat[2, 3] = 3.0
    cam = (viewmat, float(hw), float(hw), hw / 2.0, hw / 2.0, hw, hw, 0.01, 0.3, False)
    with torch.no_grad():
        out = pj._project_kernel(m, s, q, (viewmat.cpu(),) + cam[1:])
    valid = out[4]
    cots = [torch.randn(t.shape, generator=gen, device="cuda") * valid.view(-1, *([1] * (t.ndim - 1)))
            for t in out[:3] + out[5:]]
    return m, s, q, cam, cots


def load_inputs(path: str):
    """(means, scales, quats, cam_args with the viewmat on the card,
    cotangents) saved by ``chip_smoke.py --save-k4-inputs``, on the card."""
    m, s, q, cam, cots = torch.load(path, map_location="cuda")
    return m, s, q, (cam[0].cuda(),) + tuple(cam[1:]), [c.cuda() for c in cots]


def routes(pj, m, s, q, cam, cots) -> dict:
    """{route: one backward call} of the tree whose ``projection`` is pj."""
    host = (cam[0].cpu(),) + tuple(cam[1:])
    fns = {"default": lambda: pj._project_bwd_kernel(m, s, q, host, *cots)}
    if "need_viewmat" in inspect.signature(pj._project_bwd_kernel).parameters:
        fns["device_viewmat"] = lambda: pj._project_bwd_kernel(m, s, q, cam, *cots)
        fns["viewmat"] = lambda: pj._project_bwd_kernel(m, s, q, cam, *cots, need_viewmat=True)
    return fns


def time_routes(pj, ppj, args, rounds: int = 2) -> dict:
    """Every route of both trees at one input set (``args``), in turns."""
    fns = routes(pj, *args)
    if ppj is not None:  # the parent's routes first and last in each round
        parent = routes(ppj, *args)
        fns = {"parent_default": parent.pop("default"), **fns, **{f"parent_{k}": f for k, f in parent.items()}}
    rec = {k: {"ms": [], "batch_ms": [], "device_ms": []} for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            rec[k]["ms"].append(median_ms(fn))
            rec[k]["batch_ms"].append(batch_ms(fn))
            rec[k]["device_ms"].append(route_device_ms(fn))
    return {k: {kk: statistics.fmean(v) for kk, v in r.items()} | {"runs": r} for k, r in rec.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", required=True)
    parser.add_argument("--n", type=int, nargs="+", default=[100_000, 1_000_000])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--parent", default=None, help="root of another checkout to time in turns")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--inputs", default=None, help="time one saved input set instead of --n's random ones")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_bwd_time needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    pj, ppj = load_projection(args.parent)
    sets = [(args.inputs, load_inputs(args.inputs))] if args.inputs else [(n, inputs(pj, n, args.seed)) for n in args.n]
    for what, x in sets:
        line = json.dumps({"label": args.label, "package": pj.__file__, "parent": ppj and ppj.__file__, "card": card,
                           "n": int(x[0].shape[0]), "inputs": what, "routes": time_routes(pj, ppj, x, args.rounds)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
