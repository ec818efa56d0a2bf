#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nerfstudio_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``nerfstudio_torch/csrc`` (one nvcc
per source, in parallel), holds each against its plain PyTorch twin at the
shapes its path gives it, and drives the port's paths from random weights:

* nerfacto at the shipped width (phases 3-12): K1 forward and K3, each in
  every design, and K1 backward against a float64 run of its twin; the
  render (four 512x512 frames through ``render_camera``, the kernels
  launched once per chunk in their default design; a 128x128 frame on the
  card against the CPU twins) and the training step (bench.py's setup:
  steps 256-259, then 12 warm-up and 50 timed steady-state steps from step
  6000, with the kernels' launches checked per step; a torch.profiler
  breakdown of three steady steps; one step on the card against the CPU
  twins); the 512x512 frame timed with K1 and K3 in each design in turns,
  a profile of one frame in each, and the positions and tables that one of
  its chunks hands to K1 and K3, captured for phase 30;
* splatfacto at the shipped config on tools/bench_models.py's setup
  (phases 13-19): K4 forward and backward, K5 and K6 forward and backward
  against their twins at 100,000 slots and 512^2; training through
  ``SplatPipeline.train``'s schedule from step 6000 (the step, refine with
  an opacity reset, 5 warm-up and 30 timed steps, one launch of each of the
  five kernels checked per step); a profile of three steps, one refine and
  one 512^2 eval render timed; one 128^2 step on the card against the CPU
  twins;
* neus-facto at the shipped config (phases 20-27): K7 forward and backward
  against their twins (the backward against a float64 run) at the proposal
  nets' shapes; the five gather probes at their own shapes through their
  entry points, against their twins and their PyTorch library calls;
  training on bench.py's scene at 2048 rays (steps 300-301, then warm-up
  and timed steps from 6000, two K7 forward and two backward launches
  checked per step), a profile of three steps, one 512^2 eval frame through
  ``render_camera`` and one step on the card against the CPU twins;
* K6's backward at the inputs of one trained-state splat step (phase 28);
* the kernels with more than one design (phases 29-30), each design
  against the twin and timed in turns on the same inputs: the per-lane
  gather of run_case and f4 (shared-memory table columns at the lanes that
  fit and at fewer, and one thread per element) at every variant of the
  probes and at f4 with indices over the whole int32 range; K1's forward
  and K3 (lane groups, one thread per stencil) at the check inputs and at
  the captured inputs of a render chunk;
* K1's and K7's backward in both designs (phase 31): one thread per sample,
  and lane groups with vector reductions (K7's, asked for the table
  gradient alone as a neus-facto step asks, with the dense coarse levels
  privatised in shared memory), each against the float64 twin and timed in
  turns beside the "scatter alone" yardstick (``index_add_`` of the same
  (entry, value) pairs), at the check inputs of phases 5, 6 and 21 and at
  the inputs captured from one steady nerfacto step and from both K7
  backward calls of one steady neus-facto step.

Times the kernels, their twins and their library calls, the nerfacto frame
and training rays/s, the splatfacto step, refine and eval frame, and the
neus-facto step and eval frame; computes each kernel's bound (the least
time the card could take for the same work: bytes at 3.35 TB/s or float32
operations at 67 TFLOP/s, whichever is longer).

Phases print one line each. Any failure raises, so the exit code is nonzero
and the final line is missing. On success the last two lines are the
per-kernel JSON record and ``{"ok": true, "device": {...}}``. Needs a CUDA
device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
CHUNK = 1 << 15  # nerfacto's eval_num_rays_per_chunk (method config)
FRAME_HW = 512
NUM_FRAMES = 4
CHECK_HW = 128
NUM_CAMERAS = 8
TIMED_RUNS = 20

# Kernel vs twin: the geometry (cells, odd-axis rounding) is bit-identical,
# so the outputs differ only by the order of an 8-term float32 sum (~1e-7 on
# values in +-1). 1e-3 on any one sample would mean a different rounding
# choice or a different block.
KERNEL_MAX_ABS = 1e-5
KERNEL_FLIP = 1e-3

# The least time the card could take (H100 SXM data sheet): HBM bytes per
# second, and float32
# operations per second outside the tensor cores (every kernel here is
# float32 scalar arithmetic).
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, operations: float):
    """(bound_ms, bound_by) of a kernel that reads its inputs once, writes
    its outputs once and does ``operations`` float32 operations."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = operations / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# float32 operations per (sample, level) of the hash-grid kernels, counted
# from their sources: three axes (scale, floor, offset, clip, and the
# odd-axis coin where there is one) ~24, eight corner weights 16, and F
# multiply-adds per corner; the backward has the geometry, F per corner for
# the table gradient and, where the positions' gradient is asked, F more for
# the weights' gradient and 72 for the positions'.
def hash_fwd_ops(n, levels, f):
    return n * levels * (24 + 16 + 16 * f)


def hash_bwd_ops(n, levels, f, need_positions=True):
    return n * levels * (24 + 16 + 16 * f + (16 * f + 72 if need_positions else 0))


# Card vs CPU twins, rgb and accumulation mean abs: the MLPs run in bf16 on
# both sides but round products in another order (a bf16 ulp is 0.4%), and
# the CPU and CUDA sums and cumsums differ in the last bits of sample
# positions, which redraws K1's stochastic rounding on those samples and
# moves proposal samples a little.
CARD_VS_CPU_MEAN_ABS = 1e-2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median over ``runs`` of one call's time between CUDA events."""
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


def device_ms(fn, runs: int = 10) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' durations
    under torch.profiler over ``runs`` calls (after one warm-up), divided by
    ``runs``; unlike CUDA events around a single call it leaves out the host's
    time to launch it. NaN when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sum(spans) / 1e3 / runs if spans else float("nan")


def paired_ms(fns, runs: int = TIMED_RUNS):
    """{key: (mean, [median, median])} of ``median_ms`` taken twice per
    function, in order and then in reverse, so versions compared within one
    run share its drift."""
    got = {k: [] for k in fns}
    for k in list(fns) + list(reversed(fns)):
        got[k].append(median_ms(fns[k], runs=runs))
    return {k: (statistics.fmean(v), v) for k, v in got.items()}


# --------------------------------------------------------------------------
# kernels vs twins


def kernel_inputs(n, num_levels, log2_t, features, min_res, max_res, device, gen):
    """Positions uniform in [0,1]^3 with boundary rows (0, 1, -0.1, 1.1, and
    exact odd and even cell corners and centres at every level), and a
    table uniform in +-1."""
    from nerfstudio_torch.ops.hash_grid import compute_level_resolutions

    pos = torch.rand((n, 3), generator=gen, device=device)
    special = [0.0, 1.0, -0.1, 1.1]
    for res in compute_level_resolutions(num_levels, min_res, max_res):
        res = int(res)
        for i in (1, 2, 3, res // 2, res // 2 + 1, res - 1):
            special += [i / res, (i + 0.5) / res]
    vals = torch.tensor(special, dtype=torch.float32, device=device)
    k = len(special)
    idx = torch.arange(min(k**3, n // 4), device=device)
    pos[: idx.numel()] = torch.stack([vals[idx // (k * k)], vals[(idx // k) % k], vals[idx % k]], dim=-1)
    t = 2**log2_t
    table = torch.empty((num_levels, t * features // 128, 128), device=device)
    table.uniform_(-1.0, 1.0, generator=gen)
    return pos.contiguous(), table


def check_kernel(name, exact, n, num_levels, log2_t, features, min_res, max_res, gen):
    """K1 (or K3 if ``exact``) in every design against its twin at one of
    the slice's shapes, on ``kernel_inputs``."""
    pos, table = kernel_inputs(n, num_levels, log2_t, features, min_res, max_res, "cuda", gen)
    kw = dict(min_res=min_res, max_res=max_res, hash_table_size=2**log2_t)
    return check_block_designs(name, exact, pos, table, kw,
                               f"N={n} L={num_levels} F={features} T=2^{log2_t} max_res={max_res}")


def check_block_designs(name, exact, pos, table, kw, what):
    """Every design of K1 (or K3) against the twin on ``pos``, ``table``:
    each within KERNEL_MAX_ABS, no sample off by KERNEL_FLIP. Returns ({design:
    max abs err}, timing {design: fn, "kernel": the default design, "twin":
    the twin}, bound)."""
    from nerfstudio_torch.ops import hash_grid as hg

    twin = hg._block_exact_twin if exact else hg._block_stochastic_twin
    errs, parts, bad = {}, [], []
    with torch.no_grad():
        ref = twin(pos, table, **kw)
        for design in hg.DESIGNS:
            out = hg._block_kernel(pos, table, exact=exact, _design=design, **kw)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            errs[design] = float(diff.max())
            flipped = int((diff.amax(dim=-1) > KERNEL_FLIP).sum())
            parts.append(f"{design}: max |kernel - twin| = {errs[design]:.3g}, samples off by > {KERNEL_FLIP}: "
                         f"{flipped}")
            if not torch.isfinite(out).all() or errs[design] > KERNEL_MAX_ABS or flipped:
                bad.append(design)
    log(name, what + f" (limit {KERNEL_MAX_ABS}); " + "; ".join(parts))
    if bad:
        raise AssertionError(f"{name}: the {bad} kernels disagree with their twin")
    timing = {d: (lambda d=d: hg._block_kernel(pos, table, exact=exact, _design=d, **kw)) for d in hg.DESIGNS}
    timing["kernel"] = lambda: hg._block_kernel(pos, table, exact=exact, **kw)
    timing["twin"] = lambda: twin(pos, table, **kw)
    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    return errs, timing, bound(nbytes(pos, table, ref), hash_fwd_ops(pos.shape[0], L, F))


def capture_block_inputs(model, grid, cams):
    """The positions and table that one chunk of a FRAME_HW^2 frame hands to
    K1 (the proposal net) and to K3 (the field), as ``render_camera``'s own
    calls of ``hash_grid._block_kernel`` pass them (cloned): the frame's
    middle chunk, whose rays cross the occupied sphere. {exact: (pos, table,
    geometry kwargs)}."""
    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.ops import hash_grid as hg

    chunks = math.ceil(FRAME_HW * FRAME_HW / CHUNK)
    pick = chunks // 2
    seen, launch = {False: [], True: []}, hg._block_kernel

    def capture(pos, table, *, exact, **kw):
        calls = seen[exact]
        calls.append((pos.clone(), table.detach().clone(), kw) if len(calls) == pick else None)
        return launch(pos, table, exact=exact, **kw)

    hg._block_kernel = capture
    try:
        render_camera(model, None, cams, 0, CHUNK, aux=grid)
    finally:
        hg._block_kernel = launch
    if any(len(calls) != chunks for calls in seen.values()):
        raise AssertionError(f"one frame called K1 and K3 {[len(c) for c in seen.values()]} times, not {chunks}")
    return {exact: calls[pick] for exact, calls in seen.items()}


def render_in_design(model, grid, cams, design):
    """One FRAME_HW^2 frame through ``render_camera`` with K1 and K3 launched
    in ``design`` (one of ``hash_grid.DESIGNS``): the frame's time is
    compared across designs in one call."""
    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.ops import hash_grid as hg

    launch = hg._block_kernel
    hg._block_kernel = lambda pos, table, **kw: launch(pos, table, _design=design, **kw)
    try:
        return render_camera(model, None, cams, 0, CHUNK, aux=grid)
    finally:
        hg._block_kernel = launch


def time_block_designs(timing):
    """Every design of K1 or K3 timed in turns (``paired_ms``) and by the
    profiler's device time: ({design: (mean, [medians])}, {design: ms})."""
    from nerfstudio_torch.ops import hash_grid as hg

    fns = {d: timing[d] for d in hg.DESIGNS}
    with torch.no_grad():
        return paired_ms(fns), {d: device_ms(fn) for d, fn in fns.items()}


def hash_kernel_of(name: str):
    """"K1" or "K3" for a hash-grid forward kernel's profiler name, else
    None: the lane kernels by name, the per-thread kernel by its kExact
    template argument."""
    name = name.lower()
    if "block_stochastic_lanes" in name or ("block_encode_kernel<" in name and "false>" in name):
        return "K1"
    if "block_exact_lanes" in name or ("block_encode_kernel<" in name and "true>" in name):
        return "K3"
    return None


U32 = 2.0**-24  # float32 unit roundoff


def table_grad_bound(pos, table, g, scales, kw):
    """Per-entry limit on |kernel - float64 twin| of the table gradient: a
    float32 sum of k terms in any order is off by at most (k-1) * u * sum|t|
    (u = 2^-24), plus the four roundings of each term w8*g*scale. sum|t| is the
    float64 twin on |g| (weights and scales are >= 0); k counts each entry's
    terms from the geometry. Every design rounds each term as the first
    does; the lane groups' vector reductions only regroup the sum, so the
    bound holds for each unchanged."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, lanes = table.shape
    F = 128 * S // kw["hash_table_size"]
    abs_sum, _ = hg._block_stochastic_twin_bwd(pos, table, g.abs(), scales, need_positions=False,
                                               dtype=torch.float64, **kw)
    counts = torch.zeros((L, S * lanes), dtype=torch.float64, device=pos.device)
    geom = hg.block_level_geometry(pos, num_levels=L, features_per_level=F, **kw)
    for l, (rows, slot, w8) in enumerate(geom):
        if scales[l]:
            idx = hg._block_lanes(rows, slot, F).view(-1, 8, F)
            live = (w8 != 0)[:, :, None].expand_as(idx)
            counts[l] += torch.bincount(idx[live], minlength=S * lanes).double()
    return ((counts + 4.0) * U32 * abs_sum.view(L, -1)).view(L, S, lanes)


def position_grad_bound(g, num_levels, features, min_res, max_res):
    """Per-sample limit on |kernel - float64 twin| of the position gradient.
    Each level adds res * clip' * d_o, d_o a signed sum of 8 terms
    d_w8[c] * (two weights in [0, 1]), d_w8[c] a sum of F products with
    bf16 table values in +-1; every step rounds once, so a level is off by
    at most ~(F + 12) u times res * 8 * sum_f |g_lf|, and the levels' sum
    adds L roundings more."""
    from nerfstudio_torch.ops.hash_grid import compute_level_resolutions

    res = torch.tensor(compute_level_resolutions(num_levels, min_res, max_res), dtype=torch.float64,
                       device=g.device)
    per_level = g.abs().double().view(g.shape[0], num_levels, features).sum(-1) * res * 8.0
    return (features + 12 + num_levels) * U32 * per_level.sum(-1, keepdim=True)


def check_kernel_bwd(name, n, num_levels, log2_t, features, min_res, max_res, scales, gen):
    """K1 backward against its float64 twin at one of the slice's shapes."""
    from nerfstudio_torch.ops import hash_grid as hg

    pos, table = kernel_inputs(n, num_levels, log2_t, features, min_res, max_res, "cuda", gen)
    g = torch.randn((n, num_levels * features), generator=gen, device="cuda")
    kw = dict(min_res=min_res, max_res=max_res, hash_table_size=2**log2_t)
    d_tab, d_pos = hg._block_bwd_kernel(pos, table, g, scales, **kw)
    ref_tab, ref_pos = hg._block_stochastic_twin_bwd(pos, table, g, scales, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    tab_err = (d_tab.double() - ref_tab).abs()
    pos_err = (d_pos.double() - ref_pos).abs()
    tab_over = int((tab_err > table_grad_bound(pos, table, g, scales, kw)).sum())
    pos_over = int((pos_err > position_grad_bound(g, num_levels, features, min_res, max_res)).sum())
    inactive = [l for l, s in enumerate(scales) if not s]
    silent = all(not d_tab[l].any() for l in inactive)
    max_abs = max(float(tab_err.max()), float(pos_err.max()))
    log(name, f"N={n} L={num_levels} F={features} T=2^{log2_t} scales={list(scales)}: "
        f"max |kernel - float64 twin| d_table {float(tab_err.max()):.3g} (peak {float(ref_tab.abs().max()):.3g}), "
        f"d_positions {float(pos_err.max()):.3g} (peak {float(ref_pos.abs().max()):.3g}); "
        f"entries over their summation-order limit: {tab_over} of d_table, {pos_over} of d_positions; "
        f"inactive levels {inactive} untouched: {silent}")
    if tab_over or pos_over or not silent or not (torch.isfinite(d_tab).all() and torch.isfinite(d_pos).all()):
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    timing = dict(
        kernel=lambda: hg._block_bwd_kernel(pos, table, g, scales, **kw),
        twin=lambda: hg._block_stochastic_twin_bwd(pos, table, g, scales, **kw),
    )
    return (max_abs, timing, bound(nbytes(pos, table, g, d_tab, d_pos), hash_bwd_ops(n, num_levels, features)),
            (pos, table, g, kw))


# --------------------------------------------------------------------------
# the slice: nerfacto eval render


def orbit_cameras(n: int, hw: int, device, radius: float = 2.0, height: float = 1.0):
    from nerfstudio_torch.cameras.cameras import Cameras

    c2w = np.zeros((n, 3, 4), np.float32)
    for i, t in enumerate(2 * np.pi * np.arange(n) / n):
        pos = np.array([radius * np.cos(t), radius * np.sin(t), height])
        fwd = pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 0, 1]), fwd)
        right /= np.linalg.norm(right)
        c2w[i, :, 0] = right
        c2w[i, :, 1] = np.cross(fwd, right)
        c2w[i, :, 2] = fwd
        c2w[i, :, 3] = pos
    return Cameras.create(c2w, hw * 1.2, hw * 1.2, hw / 2, hw / 2, hw, hw, device=device)


def build_nerfacto(device):
    """nerfacto at the method config's width, random weights from SEED, hash
    tables widened to +-1 and the density scale raised from 0.01 to 1 so the
    render has structure (at 0.01 random weights render almost transparent),
    and an occupancy grid holding a sphere of radius 0.3 around the
    normalised cube's centre."""
    from nerfstudio_torch.field_components.encodings import HashEncoding
    from nerfstudio_torch.models.nerfacto import NerfactoModelConfig

    cfg = NerfactoModelConfig(eval_num_rays_per_chunk=CHUNK, average_init_density=1.0)
    model = cfg.setup(num_train_data=NUM_CAMERAS, device=device).eval()
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.reset_parameters(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, HashEncoding):
                m.hash_table.uniform_(-1.0, 1.0, generator=gen)
    grid = model.init_aux(model, cfg, device)
    res = grid.resolution
    c = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) / res - 0.5
    d2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    grid.binary = (d2 <= 0.3**2).reshape(-1)
    return model, grid


EXPECTED_OUTPUTS = {"rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1, "prop_depth_0": 1}


def check_outputs(images, hw):
    for k, c in EXPECTED_OUTPUTS.items():
        if k not in images or tuple(images[k].shape) != (hw, hw, c):
            raise AssertionError(f"{k}: expected shape {(hw, hw, c)}, got {None if k not in images else tuple(images[k].shape)}")
        if not torch.isfinite(images[k]).all():
            raise AssertionError(f"{k}: non-finite values")


# --------------------------------------------------------------------------
# the training slice: nerfacto's train step, as bench.py drives it


TRAIN_HW = 128  # bench.py:69-72: 16 orbit cameras of 128^2 random images, 8192 rays
TRAIN_IMAGES = 16
TRAIN_RAYS = 8192
STEADY_START, STEADY_WARMUP, STEADY_TIMED = 6000, 12, 50  # bench.py:149-156
CHECK_RAYS = 1024
PROFILED_STEPS = 3

# Card vs CPU twins, one training step from the same weights and draws with
# flat hash tables (one value per level and feature: K1 then returns that
# value whichever corners it picks, so the step does not depend on the
# rounding choices the card's and the CPU's sums redraw). The MLPs run in
# bf16 on both sides but round products in another order (a bf16 ulp is
# 0.4%): the loss within 2e-3 relative, each non-table gradient within 5e-2
# of its largest entry, and each table's gradient summed per level and
# feature within 1e-2 of the largest such sum (a sum over every sample of
# the encoding's bf16-level cotangent).
STEP_LOSS_RTOL = 2e-3
STEP_GRAD_REL = 5e-2
STEP_TABLE_SUM_REL = 1e-2


def build_training(device, rays):
    """nerfacto at the method config's width and schedule
    (configs/method_configs.py:92-110: field_bwd_level_period=2,
    proposal_freeze_after=2500), random weights from SEED, bench.py's
    synthetic scene, its pipeline, a fresh per-group Adam and the occupancy
    hook. Returns (config, pipeline, train state, hook)."""
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam, nerfacto_optimizers
    from nerfstudio_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline

    cfg = NerfactoModelConfig(eval_num_rays_per_chunk=CHUNK, field_bwd_level_period=2, proposal_freeze_after=2500)
    model = cfg.setup(num_train_data=TRAIN_IMAGES, device=device).train()
    model.reset_parameters(torch.Generator(device=device).manual_seed(SEED))
    images = np.random.default_rng(SEED).integers(0, 255, (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW, 3)).astype(np.uint8)
    dm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=rays),
                                orbit_cameras(TRAIN_IMAGES, TRAIN_HW, device), torch.from_numpy(images), device)
    state = TrainState(PerGroupAdam(nerfacto_optimizers(), model), aux=model.init_aux(model, cfg, device))
    return cfg, VanillaPipeline(dm, model), state, NerfactoModel.make_aux_update_fn(model, cfg)


def train_steps(cfg, pipeline, state, hook, steps, gen, check_launches=True):
    """Run the trainer's loop over ``steps``: occupancy hook, the step's
    kwargs, one train step. With ``check_launches``, each step must launch
    one field K1 forward and backward, one proposal K1 forward, a proposal
    backward only when ``update_proposals`` is on, one more K1 forward on an
    occupancy update, no K3, and no K1 forward or backward in the per-thread
    design. Returns the last step's metrics."""
    from nerfstudio_torch.models.nerfacto import NerfactoModel
    from nerfstudio_torch.ops import hash_grid as hg

    metrics = None
    for step in steps:
        before = dict(hg.launch_counts)
        state.step = step
        hook(state, step, gen)
        kwargs = NerfactoModel.step_kwargs(step, cfg)
        metrics = pipeline.train_step(state, gen, **kwargs)
        if check_launches:
            occ = step >= cfg.occ_warmup_steps and step % cfg.occ_update_every == 0
            want = {"hash_encode_block": 2 + occ, "hash_encode_block_exact": 0,
                    "hash_encode_block_bwd": 1 + bool(kwargs["update_proposals"]), "hash_encode_block_per_thread": 0,
                    "hash_encode_bwd_per_thread": 0}
            got = {k: hg.launch_counts[k] - before[k] for k in want}
            if got != want:
                raise AssertionError(f"step {step} ({kwargs}): launches {got}, expected {want}")
    return metrics


def profile_steps(cfg, pipeline, state, hook, start, gen):
    """Device time by kernel over PROFILED_STEPS steady nerfacto steps."""
    return profile_device(
        lambda: train_steps(cfg, pipeline, state, hook, range(start, start + PROFILED_STEPS), gen))


def profile_device(run, per=PROFILED_STEPS):
    """Device time by kernel over ``run()``, which takes ``per`` steps (or
    frames) (torch.profiler). Returns (rows (name, ms per step) by time,
    device-busy ms per step (the union of the kernels' intervals), device
    activities per step, matrix-product FLOPs per step (the profiler's count
    for the aten mm/addmm/bmm/baddbmm calls, from their shapes)), or None
    when the profiler saw no device activity. The profiler slows the host,
    so the caller sets the busy time against an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_flops=True) as prof:
        run()
        torch.cuda.synchronize()
    spans, by_name, gemm_flops = [], {}, 0
    for e in prof.events():
        if e.name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"):
            gemm_flops += getattr(e, "flops", 0) or 0
        # device activities only: kernels, memsets, copies; not the ranges
        # that annotations such as Optimizer.step project onto the device
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    if not spans:
        return None
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):  # length of the union of the kernels' intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    rows = sorted(((n, t / per) for n, t in by_name.items()), key=lambda r: -r[1])
    return rows, busy_us / 1e3 / per, len(spans) / per, gemm_flops / per


KERNEL_CLASSES = (  # first match wins, on the lower-cased kernel name
    ("hash-grid kernels", ("block_encode", "block_stochastic", "block_exact", "bwd_lanes", "bwd_private")),
    ("gsplat kernels", ("project_fwd", "project_bwd", "tile_keys", "tile_ranges", "blend_fwd", "blend_bwd")),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad")),
    ("GEMMs", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")),
    ("Adam (foreach)", ("multi_tensor_apply",)),
    ("cat", ("catarray",)),
    ("scans", ("scan",)),
    ("reductions", ("reduce",)),
    ("index/scatter/gather", ("index", "scatter", "gather")),
    ("sort/search", ("sort", "search")),
    ("memset/memcpy", ("memset", "memcpy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def is_k7(name: str) -> bool:
    """A K7 kernel's profiler name: the flat forward and first-design
    backward and the private pass (K7 only) by name, the lane pass by its
    kBlock = false template argument."""
    name = name.lower()
    return "flat_encode" in name or "bwd_private" in name or ("bwd_lanes" in name and "false>" in name)


def kernel_class(name: str) -> str:
    name = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def flatten_tables(model, gen):
    """Set every hash-table level to one value per feature, drawn from gen."""
    from nerfstudio_torch.field_components.encodings import HashEncoding

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, HashEncoding):
                L, S, _ = m.hash_table.shape
                F = m.features_per_level
                values = torch.rand((L, F), generator=gen) * 2 - 1
                m.hash_table.copy_(values.repeat(1, 128 // F)[:, None, :].expand(L, S, 128))


def card_vs_cpu_step(devices=("cuda", "cpu")):
    """One training step of the full-width model on the card and on the CPU
    twins: same weights (the card's, with flat tables), same grid, same
    draws."""
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.models.nerfacto import NerfactoModel
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws

    gen = torch.Generator().manual_seed(SEED + 1)
    runs = []
    draws = StepDraws(
        torch.stack([torch.randint(0, n, (CHECK_RAYS,), generator=gen)
                     for n in (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW)], dim=-1),
        SamplerUniforms(torch.rand((CHECK_RAYS, 1), generator=gen),
                        (torch.rand((CHECK_RAYS, 1), generator=gen), torch.rand((CHECK_RAYS, 1), generator=gen))),
    )
    weights = None
    for device in devices:
        cfg, pipeline, state, _ = build_training(device, CHECK_RAYS)
        if weights is None:
            flatten_tables(pipeline.model, torch.Generator().manual_seed(SEED + 2))
            weights = {k: v.detach().cpu().clone() for k, v in pipeline.model.state_dict().items()}
        pipeline.model.load_state_dict(weights)
        grid = state.aux
        c = (torch.arange(grid.resolution, device=device, dtype=torch.float32) + 0.5) / grid.resolution - 0.5
        grid.binary = (c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2 <= 0.3**2).reshape(-1)
        dev_draws = StepDraws(draws.pixels.to(device), SamplerUniforms(
            draws.sampler.probes.to(device), tuple(u.to(device) for u in draws.sampler.rounds)))
        kwargs = NerfactoModel.step_kwargs(300, cfg)  # live proposals, full field backward
        metrics = pipeline.train_step(state, draws=dev_draws, **kwargs)
        grads = {n: p.grad.detach().cpu().double() for n, p in pipeline.model.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, pipeline.model))
        del pipeline, state
    (m_card, g_card, model), (m_cpu, g_cpu, _) = runs
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    grad_rel, table_rel = 0.0, 0.0
    for n, ref in g_cpu.items():
        got = g_card[n]
        if n.endswith("hash_table"):
            F = model.get_submodule(n.rsplit(".", 1)[0]).features_per_level
            sums = lambda x: x.reshape(x.shape[0], -1, F).sum(dim=1)
            table_rel = max(table_rel, float((sums(got) - sums(ref)).abs().max() / sums(ref).abs().max()))
        elif ref.abs().max() > 0:
            grad_rel = max(grad_rel, float((got - ref).abs().max() / ref.abs().max()))
    return m_card, m_cpu, loss_rel, grad_rel, table_rel


# --------------------------------------------------------------------------
# the splatfacto slice: training step and eval render


SPLAT_HW = 512  # tools/bench_models.py:105-170
SPLAT_SLOTS, SPLAT_RANDOM, SPLAT_SCALE = 100_000, 50_000, 1.5
SPLAT_CAMERAS = 8
SPLAT_START, SPLAT_WARMUP, SPLAT_TIMED = 6000, 5, 30
SPLAT_CHECK_HW, SPLAT_CHECK_GAUSS = 128, 4096
SPLAT_KERNELS = ("project_gaussians", "project_gaussians_bwd", "tile_bin", "blend_saturating",
                 "blend_saturating_bwd")

# K4 kernel vs twin: the same float32 operations in the same order (the
# library is built without FMA contraction), so the forward differs only
# where the CUDA and the PyTorch square roots and divisions round apart:
# 1e-5 of each output's peak. radii and valid may flip only where ceil's
# argument is within 1e-5 of an integer. The backward is a hand-derived
# chain of ~300 float32 operations against autograd through the twin's:
# against a float64 run of the twin, the kernel may be off by at most twice
# the float32 twin's own error plus 1e-6 of the peak.
K4_REL = 1e-5
# K6 kernel vs twin, forward: both blend the same entries in the same order,
# but the twin's transmittance is a cumprod and its sums a matmul. A pixel
# whose transmittance lands within rounding of 1e-4 may stop one entry
# apart, which moves each channel by at most 1e-4 of its largest value, and
# a float32 sum of up to a few thousand terms adds ~1e-5: 2e-4 of each
# channel's largest value. Backward: the same cutoff seen from the replay,
# plus atomics in any order: 1e-3 of each array's peak.
K6_FWD_REL = 2e-4
K6_BWD_REL = 1e-3
# Card vs CPU twins, one splatfacto training step at 128^2 from the same
# params and draws: K6's sums and the cutoff, and cuDNN's against the CPU's
# SSIM convolutions (both full float32), differ in summation order only:
# the loss within 1e-4 relative, each gradient within 2e-3 of its peak.
SPLAT_LOSS_RTOL = 1e-4
SPLAT_GRAD_REL = 2e-3


def build_splat(device, hw=SPLAT_HW, slots=SPLAT_SLOTS, n_random=SPLAT_RANDOM, params=None):
    """splatfacto at the shipped config (sh_degree 3, saturating blend,
    big_frac 16, random background, DefaultStrategy) on
    tools/bench_models.py's setup: ``max_gaussians`` slots, ``n_random``
    random-init gaussians at random_scale 1.5 and scene_scale 1.5, no
    downscales, 8 orbit cameras at radius 2.5 and height 1.2 over random
    images from SEED. ``params`` (CPU tensors) replace the init's."""
    from nerfstudio_torch.data.datamanagers import FullImageDatamanager
    from nerfstudio_torch.models.splatfacto import SplatfactoModel, SplatfactoModelConfig
    from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline

    cfg = SplatfactoModelConfig(max_gaussians=slots, num_random=n_random, random_init=True, random_scale=SPLAT_SCALE,
                                num_downscales=0)
    images = np.random.default_rng(SEED).uniform(size=(SPLAT_CAMERAS, hw, hw, 3)).astype(np.float32)
    dm = FullImageDatamanager(orbit_cameras(SPLAT_CAMERAS, hw, "cpu", radius=2.5, height=1.2),
                              torch.from_numpy(images), seed=SEED, device=device)
    pipeline = SplatPipeline(dm, SplatfactoModel(cfg, scene_scale=SPLAT_SCALE), max_steps=30000)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        return pipeline, pipeline.init_state(scene_scale=SPLAT_SCALE, generator=gen, device=device)
    from nerfstudio_torch.models.splatfacto import SplatAux

    alive = torch.arange(slots, device=device) < n_random
    zeros = torch.zeros((slots,), device=device)
    aux = SplatAux(alive=alive, grad_accum=zeros, grad_count=zeros.clone(), max_radii=zeros.clone())
    return pipeline, pipeline.state_from({k: v.to(device) for k, v in params.items()}, aux)


def splat_kernel_inputs(pipeline, state, gen):
    """The main path's tensors at its shapes (every slot, camera 0 at
    512^2), from the initial state with scales made anisotropic and random
    quaternions (the init's isotropic scales leave the quaternion gradient
    pure rounding noise), opacities uniform in [0.05, 0.95] on the alive
    slots and random colours."""
    from nerfstudio_torch.ops.gsplat.projection import get_viewmat

    p = state.params
    n, dev = p["means"].shape[0], p["means"].device
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    means = p["means"].detach().clone()
    scales = torch.exp(p["scales"].detach() + u(n, 3) - 0.5)
    quats = torch.randn((n, 4), generator=gen, device=dev)
    c2w, K, w, h = pipeline.camera(pipeline.datamanager.train_cameras, 0)
    cam_args = (get_viewmat(c2w), *K, w, h, pipeline.model.config.near_plane, 0.3, False)
    opac = (u(n) * 0.9 + 0.05) * state.aux.alive
    return dict(means=means, scales=scales, quats=quats, cam_args=cam_args, opac=opac, colors=u(n, 3),
                alive=state.aux.alive, width=w, height=h)


def near_integer_radius(conics: torch.Tensor) -> torch.Tensor:
    """Where ceil(3 sqrt(v1)) has its argument within 1e-5 of an integer,
    v1 recomputed in float64 from the conic."""
    c = conics.double()
    det = c[:, 0] * c[:, 2] - c[:, 1] ** 2
    a, b, cc = c[:, 2] / det, -c[:, 1] / det, c[:, 0] / det
    half = 0.5 * (a + cc)
    arg = 3.0 * torch.sqrt(half + torch.sqrt(torch.clamp_min(half * half - (a * cc - b * b), 0.01)))
    return (arg - torch.round(arg)).abs() < 1e-5


def check_k4(name, x, gen):
    """K4 forward and backward against the twin, in the main path's classic
    mode and antialiased (the compensation factor and its cotangent).
    Returns (max abs err, the classic mode's timing, its outputs and the
    visible mask)."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    m, s, q = x["means"], x["scales"], x["quats"]
    runs, lines, failed, max_abs = {}, [], False, 0.0
    for antialiased in (False, True):
        cam = x["cam_args"][:-1] + (antialiased,)
        with torch.no_grad():
            out = pj._project_kernel(m, s, q, cam)
            ref = pj._project_twin(m, s, q, *cam)
        torch.cuda.synchronize()
        front = ref[1] > 1e-3  # behind the camera z is clamped to 1e-6: see the projection parity test
        pairs = dict(zip(("means2d", "depths", "conics", "compensations"), zip(out[:3] + out[5:], ref[:3] + ref[5:])))
        errs = {}
        for k, (a, b) in pairs.items():
            if not torch.isfinite(a[front]).all():
                raise AssertionError(f"{name}: non-finite {k}")
            errs[k] = float((a[front] - b[front]).abs().max() / b[front].abs().max())
            max_abs = max(max_abs, float((a[front] - b[front]).abs().max()))
        flips = (out[3] != ref[3]) | (out[4] != ref[4])
        bad_flips = int((flips & ~near_integer_radius(ref[2])).sum())
        valid = ref[4] & x["alive"]
        cots = [torch.randn(t.shape, generator=gen, device=m.device) * valid.view(-1, *([1] * (t.ndim - 1)))
                for t in ref[:3] + ref[5:]]
        got = pj._project_bwd_kernel(m, s, q, cam, *cots)
        twin = pj._project_twin_bwd(m, s, q, cam, *cots)
        ref64 = pj._project_twin_bwd(m.double(), s.double(), q.double(), cam, *(c.double() for c in cots))
        torch.cuda.synchronize()
        bwd_over, bwd_errs = [], {}
        for k, a, b, r in zip(("means", "scales", "quats"), got, twin, ref64):
            e_k, e_t = float((a.double() - r).abs().max()), float((b.double() - r).abs().max())
            peak = float(r.abs().max())
            bwd_errs[k] = (e_k / peak, e_t / peak)
            max_abs = max(max_abs, float((a - b).abs().max()))
            if e_k > 2 * e_t + 1e-6 * peak or not torch.isfinite(a).all():
                bwd_over.append(k)
        failed = failed or max(errs.values()) > K4_REL or bad_flips or bool(bwd_over)
        lines.append(
            f"{'antialiased' if antialiased else 'classic'}: forward max |kernel - twin| / peak "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f", radii/valid flips {int(flips.sum())} "
            f"({bad_flips} away from an integer ceil); backward max |x - float64 twin| / peak (kernel, float32 "
            "twin) " + ", ".join(f"{k} {a:.3g}/{b:.3g}" for k, (a, b) in bwd_errs.items())
            + f", over the limit: {bwd_over}")
        runs[antialiased] = (out, valid, cots, cam)
    log(name, f"N={m.shape[0]} ({int(runs[False][1].sum())} visible of {int(x['alive'].sum())} alive) "
        f"{x['width']}x{x['height']} (limit {K4_REL}): " + "; ".join(lines))
    if failed:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    out, valid, cots, cam = runs[False]
    n = m.shape[0]
    # ~250 float32 operations per gaussian forward (rotation, covariance,
    # Jacobian, conic, radius), ~700 backward, counted from the sources
    outs = [t for t in out if isinstance(t, torch.Tensor)]
    bounds = (bound(nbytes(m, s, q, *outs), 250 * n), bound(nbytes(m, s, q, *cots, m, s, q), 700 * n))
    timing = dict(
        fwd=lambda: pj._project_kernel(m, s, q, cam), fwd_twin=lambda: pj._project_twin(m, s, q, *cam),
        bwd=lambda: pj._project_bwd_kernel(m, s, q, cam, *cots),
        bwd_twin=lambda: pj._project_twin_bwd(m, s, q, cam, *cots),
    )
    return max_abs, timing, (out, valid), bounds


def check_k5(name, x, projected):
    """K5 against its twin: keys, ids and tile ranges exactly equal."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    (m2, z, con, radii, *_), valid = projected
    tiles_x, tiles_y = (x["width"] + 15) // 16, (x["height"] + 15) // 16
    args = (m2, radii, z, valid, tiles_x, tiles_y, 16, 16, 64)
    got = rz._tile_bin_kernel(*args)
    ref = rz._tile_bin_twin(*args)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(getattr(got, k), getattr(ref, k))) for k in ("packed", "ids", "starts", "counts")}
    counts = ref.counts.double()
    log(name, f"{int(valid.sum())} visible gaussians, {tiles_x}x{tiles_y} tiles: {got.packed.numel()} keys, "
        f"{int(counts.sum())} in tiles (per tile mean {float(counts.mean()):.0f}, max {int(counts.max())}); "
        f"kernel == twin: {same}")
    if not all(same.values()):
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    # the inputs once, the sorted keys, ids and tile ranges once (no flops to
    # speak of); the library call is the sort alone, of these keys shuffled
    bnd = bound(nbytes(m2, radii, z, valid, got.packed, got.ids, got.starts, got.counts), 0)
    shuffled = got.packed[torch.randperm(got.packed.numel(), device=got.packed.device)]
    timing = dict(kernel=lambda: rz._tile_bin_kernel(*args), twin=lambda: rz._tile_bin_twin(*args),
                  library=lambda: torch.sort(shuffled))
    return 0.0, timing, got, bnd


def k6_bwd_check(m2, con, ch, op, bins, T, last, g_ch):
    """K6's backward against its twin on one set of inputs: (max |kernel -
    twin| / peak per array, max abs err, timing fn, bound, walked). The work
    depends on the data: the entries each pixel walked (``last``), ~40
    float32 operations each."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    twin = rz._blend_twin_bwd(m2, con, ch, op, bins, g_ch)
    got = rz._blend_bwd_kernel(m2, con, ch, op, bins, T, last, g_ch)
    torch.cuda.synchronize()
    if not all(torch.isfinite(a).all() for a in got):
        raise AssertionError("K6 backward: non-finite gradient")
    rel = {k: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for k, a, b in zip(("means2d", "conics", "ch", "opac"), got, twin)}
    err = max(float((a - b).abs().max()) for a, b in zip(got, twin))
    walked = float(last.double().sum())
    bnd = bound(nbytes(m2, con, ch, op, bins.ids, bins.starts, bins.counts, T, last, g_ch, *twin), 40 * walked)
    return rel, err, (lambda: rz._blend_bwd_kernel(m2, con, ch, op, bins, T, last, g_ch)), bnd, walked


def k6_bwd_line(rel) -> str:
    return "max |kernel - twin| / peak " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + \
        f" (limit {K6_BWD_REL})"


def check_k6(name, x, projected, bins, gen):
    """K6 forward and backward against the twins."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    (m2, z, con, *_), _ = projected
    w, h = x["width"], x["height"]
    ch = torch.cat([x["colors"], z[:, None], torch.ones_like(z)[:, None]], dim=-1)
    op = x["opac"]
    with torch.no_grad():
        out, T, last = rz._blend_kernel(m2, con, ch, op, bins, w, h)
        ref = rz._blend_twin(m2, con, ch, op, bins, w, h)
    torch.cuda.synchronize()
    ch_peak = ch[x["alive"]].abs().amax(dim=0).clamp_min(1.0)
    fwd_rel = float(((out - ref).abs().amax(dim=(0, 1)) / ch_peak).max())
    # training-like cotangent: rgb, and the accumulation through rgb + bg (1 - alpha)
    g_rgb = torch.randn((h, w, 3), generator=gen, device=m2.device)
    bg = torch.rand((3,), generator=gen, device=m2.device)
    g_ch = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1]), -(g_rgb * bg).sum(-1, keepdim=True)], dim=-1)
    bwd_rel, bwd_err, bwd_timing, bwd_bound, walked = k6_bwd_check(m2, con, ch, op, bins, T, last, g_ch)
    acc = out[..., 4]
    log(name, f"{w}x{h}: mean accumulation {float(acc.mean()):.3f}, pixels at T < 1e-4: "
        f"{float((T < 1e-4).float().mean()):.3f}, entries blended per pixel mean {float(last.float().mean()):.0f}; "
        f"forward max |kernel - twin| / channel peak {fwd_rel:.3g} (limit {K6_FWD_REL}); backward "
        + k6_bwd_line(bwd_rel))
    if fwd_rel > K6_FWD_REL or max(bwd_rel.values()) > K6_BWD_REL or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    fwd_abs = float((out - ref).abs().max())
    # data-dependent work: the entries each pixel walked (``last``), ~15
    # operations each forward (conic, exp, alpha, blend of 5 channels)
    bin_t = (bins.ids, bins.starts, bins.counts)
    bounds = (bound(nbytes(m2, con, ch, op, *bin_t, out, T, last), 15 * walked), bwd_bound)
    timing = dict(
        fwd=lambda: rz._blend_kernel(m2, con, ch, op, bins, w, h),
        fwd_twin=lambda: rz._blend_twin(m2, con, ch, op, bins, w, h),
        bwd=bwd_timing,
        bwd_twin=lambda: rz._blend_twin_bwd(m2, con, ch, op, bins, g_ch),
    )
    return (fwd_abs, bwd_err), timing, bounds, walked


def capture_k6_bwd(pipeline, state, gen):
    """The arguments of K6's backward in one steady-state splat step, as
    the step's own autograd call hands them over (tensors cloned): means2d,
    conics, ch, opac, the bins, T, last and the cotangent g_ch."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    seen, launch = [], rz._blend_bwd_kernel

    def capture(*args):
        seen.append([a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args])
        return launch(*args)

    rz._blend_bwd_kernel = capture
    try:
        splat_steps(pipeline, state, 1, gen)
    finally:
        rz._blend_bwd_kernel = launch
    if len(seen) != 1:
        raise AssertionError(f"one splat step called K6's backward {len(seen)} times")
    return seen[0]


def splat_steps(pipeline, state, n, gen):
    """``n`` steps through ``SplatPipeline.train``'s schedule, each checked
    for exactly one launch of each of the five kernels. Returns the last
    step's metrics."""
    from nerfstudio_torch.ops.gsplat import _cuda as sc

    metrics = None
    for _ in range(n):
        before = dict(sc.launch_counts)
        state, metrics = pipeline.train(state, state.step + 1, gen)
        got = {k: sc.launch_counts[k] - before[k] for k in SPLAT_KERNELS}
        if got != dict.fromkeys(SPLAT_KERNELS, 1):
            raise AssertionError(f"step {state.step - 1}: launches {got}, expected one of each")
    return metrics


def splat_card_vs_cpu():
    """One splatfacto training step at 128^2 with SPLAT_CHECK_GAUSS
    gaussians on the card and on the CPU twins, from the same params (the
    CPU init with anisotropic scales, random quaternions and SH rest
    coefficients, so every gradient has structure) and the same background."""
    gen = torch.Generator().manual_seed(SEED + 3)
    _, state = build_splat("cpu", SPLAT_CHECK_HW, SPLAT_CHECK_GAUSS, SPLAT_CHECK_GAUSS)
    n = SPLAT_CHECK_GAUSS
    params = {k: v.detach().clone() for k, v in state.params.items()}
    params["scales"] += torch.rand((n, 3), generator=gen) - 0.5
    params["quats"] = torch.randn((n, 4), generator=gen)
    params["features_rest"] = torch.randn(params["features_rest"].shape, generator=gen) * 0.1
    bg = torch.rand((3,), generator=gen)
    runs = []
    for device in ("cuda", "cpu"):
        pipeline, state = build_splat(device, SPLAT_CHECK_HW, n, n, params=params)
        c2w, K, w, h = pipeline.camera(pipeline.datamanager.train_cameras, 1)
        image = pipeline.datamanager.train_images[1]
        metrics = pipeline.train_step(state, c2w, K, image, bg.to(device), w, h, 3)
        grads = {k: p.grad.detach().cpu().double() for k, p in state.params.items()}
        runs.append((float(metrics["loss"]), grads))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()) for k in g_cpu}
    return l_card, l_cpu, abs(l_card - l_cpu) / abs(l_cpu), rel


# --------------------------------------------------------------------------
# the neus-facto slice: K7, the gather probes, training and eval


# neus-facto's proposal nets (fields/density_fields.py defaults, no
# contraction): L5 F2 T=2^17, resolutions 16..128 (3 dense, 2 hashed levels)
PROP_LEVELS, PROP_LOG2_T, PROP_F, PROP_MIN_RES, PROP_MAX_RES = 5, 17, 2, 16, 128
NEUS_RAYS = 2048  # the method config's train_num_rays_per_batch and eval chunk
NEUS_SAMPLES = (256, 96)  # proposal samples per ray, rounds 1 and 2
NEUS_EARLY, NEUS_START, NEUS_WARMUP, NEUS_TIMED = 300, 6000, 3, 10
NEUS_CHECK_RAYS = 128
NEUS_KERNELS = ("hash_encode_flat", "hash_encode_flat_bwd")

# K7 kernel vs twin: the same float32 operations in the same order (the
# library is built without FMA contraction), so the forward is expected
# equal; 1e-5 on values in +-1 would mean a different corner or rounding.
K7_MAX_ABS = 1e-5
# Card vs CPU twins, one neus-facto step at full width from the same
# weights and draws: the SDF field runs float32 on both sides (cuBLAS and
# the CPU's products sum in another order), the proposal MLPs bf16 (a bf16
# ulp is 0.4%), which moves samples by float32 ulps; the eikonal term's
# second derivative amplifies those through the positional encoding's top
# frequency (the CPU tests measured 3e-3 of peak on those layers). The loss
# is a mean over the batch and moved by 1.0e-7 relative on an H100 80GB
# HBM3 (700 W): within 1e-5 relative; each gradient within 5e-2 of its
# peak (4.8e-3 measured there, at the first proposal MLP layer, bf16).
NEUS_LOSS_RTOL = 1e-5
NEUS_GRAD_REL = 5e-2


def flat_table_grad_bound(pos, table, g, kw):
    """Per-entry limit on |kernel - float64 twin| of K7's table gradient:
    (terms - 1) * u * sum|t| for a float32 sum in any order, plus two
    roundings per term (w = (wx*wy)*wz, then w*g); sum|t| is the float64
    twin on |g|, the term count each lane's from the corners of nonzero
    weight. As for table_grad_bound, every design rounds each term the same
    way and only regroups the sum: the lane groups' vector reductions, and
    the privatised levels' warp scans, shared copies and slab sums."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, lanes = table.shape
    F = 128 * S // kw["hash_table_size"]
    abs_sum, _ = hg._flat_twin_bwd(pos, table, g.abs(), need_positions=False, dtype=torch.float64, **kw)
    counts = torch.zeros((L, S * lanes), dtype=torch.float64, device=pos.device)
    feat = torch.arange(F, device=pos.device)
    for l, res in enumerate(hg.compute_level_resolutions(L, kw["min_res"], kw["max_res"])):
        entries, weights = hg._level_corners(pos, int(res), kw["hash_table_size"])
        w8 = torch.stack([hg._corner_weight(weights, c) for c in range(8)], dim=-1)
        idx = entries[:, :, None] * F + feat
        live = (w8 != 0)[:, :, None].expand_as(idx)
        counts[l] += torch.bincount(idx[live], minlength=S * lanes).double()
    return ((counts + 4.0) * U32 * abs_sum.view(L, -1)).view(L, S, lanes)


def check_flat(name, n, gen):
    """K7 forward against its twin at one of the proposal nets' shapes."""
    from nerfstudio_torch.ops import hash_grid as hg

    pos, table = kernel_inputs(n, PROP_LEVELS, PROP_LOG2_T, PROP_F, PROP_MIN_RES, PROP_MAX_RES, "cuda", gen)
    kw = dict(min_res=PROP_MIN_RES, max_res=PROP_MAX_RES, hash_table_size=2**PROP_LOG2_T)
    with torch.no_grad():
        out = hg._flat_kernel(pos, table, **kw)
        ref = hg._flat_twin(pos, table, **kw)
    torch.cuda.synchronize()
    max_abs = float((out - ref).abs().max())
    equal = bool(torch.equal(out, ref))
    log(name, f"N={n} L={PROP_LEVELS} F={PROP_F} T=2^{PROP_LOG2_T} res {PROP_MIN_RES}-{PROP_MAX_RES}: "
        f"max |kernel - twin| = {max_abs:.3g} (limit {K7_MAX_ABS}), bit-equal: {equal}")
    if not torch.isfinite(out).all() or max_abs > K7_MAX_ABS:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    timing = dict(kernel=lambda: hg._flat_kernel(pos, table, **kw), twin=lambda: hg._flat_twin(pos, table, **kw))
    return max_abs, timing, bound(nbytes(pos, table, out), hash_fwd_ops(n, PROP_LEVELS, PROP_F))


def check_flat_bwd(name, n, gen):
    """K7 backward (table and positions) against its float64 twin."""
    from nerfstudio_torch.ops import hash_grid as hg

    pos, table = kernel_inputs(n, PROP_LEVELS, PROP_LOG2_T, PROP_F, PROP_MIN_RES, PROP_MAX_RES, "cuda", gen)
    g = torch.randn((n, PROP_LEVELS * PROP_F), generator=gen, device="cuda")
    kw = dict(min_res=PROP_MIN_RES, max_res=PROP_MAX_RES, hash_table_size=2**PROP_LOG2_T)
    d_tab, d_pos = hg._flat_bwd_kernel(pos, table, g, **kw)
    ref_tab, ref_pos = hg._flat_twin_bwd(pos, table, g, dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    tab_err = (d_tab.double() - ref_tab).abs()
    pos_err = (d_pos.double() - ref_pos).abs()
    tab_over = int((tab_err > flat_table_grad_bound(pos, table, g, kw)).sum())
    pos_over = int((pos_err > position_grad_bound(g, PROP_LEVELS, PROP_F, PROP_MIN_RES, PROP_MAX_RES)).sum())
    max_abs = max(float(tab_err.max()), float(pos_err.max()))
    log(name, f"N={n} L={PROP_LEVELS} F={PROP_F} T=2^{PROP_LOG2_T}: max |kernel - float64 twin| d_table "
        f"{float(tab_err.max()):.3g} (peak {float(ref_tab.abs().max()):.3g}), d_positions {float(pos_err.max()):.3g} "
        f"(peak {float(ref_pos.abs().max()):.3g}); entries over their summation-order limit: {tab_over} of "
        f"d_table, {pos_over} of d_positions")
    if tab_over or pos_over or not (torch.isfinite(d_tab).all() and torch.isfinite(d_pos).all()):
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    timing = dict(kernel=lambda: hg._flat_bwd_kernel(pos, table, g, **kw),
                  twin=lambda: hg._flat_twin_bwd(pos, table, g, **kw))
    return (max_abs, timing, bound(nbytes(pos, table, g, d_tab, d_pos), hash_bwd_ops(n, PROP_LEVELS, PROP_F)),
            (pos, table, g, kw))


# --------------------------------------------------------------------------
# the backward's designs (K1 bwd, K7 bwd): every design against the float64
# twin and timed in turns, at the check inputs and at a step's own inputs


def capture_calls(name, run):
    """The arguments of every call of ``hash_grid.<name>`` (a backward's
    launcher) during ``run()``, as the step's own autograd hands them over
    (tensors cloned): [(args, kwargs)]."""
    from nerfstudio_torch.ops import hash_grid as hg

    seen, launch = [], getattr(hg, name)

    def capture(*args, **kw):
        seen.append(([a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args], dict(kw)))
        return launch(*args, **kw)

    setattr(hg, name, capture)
    try:
        run()
    finally:
        setattr(hg, name, launch)
    return seen


def scatter_pairs(kind, pos, table, g, scales, kw):
    """The (flat table index, value) pairs the backward adds into the table
    gradient, from the twin's geometry: corners of nonzero weight on levels
    with a gradient, value w*g (K7) or scale*w*g (K1). ``index_add_`` of
    them is the "scatter alone" yardstick: the scatter without the geometry,
    the position gradient or the vector reductions."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, lanes = table.shape
    F = 128 * S // kw["hash_table_size"]
    idx, vals = [], []
    if kind == "K1":
        geom = hg.block_level_geometry(pos, num_levels=L, features_per_level=F, **kw)
        for l, (rows, slot, w8) in enumerate(geom):
            if scales[l]:
                live = (w8 != 0)[:, :, None].expand(-1, -1, F)
                idx.append((hg._block_lanes(rows, slot, F).view(-1, 8, F) + l * S * lanes)[live])
                vals.append((scales[l] * w8[:, :, None] * g[:, None, l * F:(l + 1) * F])[live])
    else:
        feat = torch.arange(F, device=pos.device)
        for l, res in enumerate(hg.compute_level_resolutions(L, kw["min_res"], kw["max_res"])):
            entries, weights = hg._level_corners(pos, int(res), kw["hash_table_size"])
            w8 = torch.stack([hg._corner_weight(weights, c) for c in range(8)], dim=-1)
            live = (w8 != 0)[:, :, None].expand(-1, -1, F)
            idx.append((entries[:, :, None] * F + feat + l * S * lanes)[live])
            vals.append((w8[:, :, None] * g[:, None, l * F:(l + 1) * F])[live])
    return torch.cat(idx), torch.cat(vals)


def check_bwd_designs(name, kind, pos, table, g, kw, scales=None, need_positions=True, need_table=True):
    """Every design of K1's (``kind`` "K1", with ``scales``) or K7's backward
    against the float64 twin on one set of inputs: the table gradient within
    its summation-order bound on every entry, the positions within theirs,
    K1's levels of scale 0 untouched; then every design and the "scatter
    alone" yardstick timed in turns (CUDA events, ``paired_ms``) and by the
    profiler's device time. Returns a record: n, scales, needs, bound,
    {design: errors and times}, the yardstick's times."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    n = pos.shape[0]
    needs = dict(need_positions=need_positions, need_table=need_table)
    if kind == "K7":
        ref_tab, ref_pos = hg._flat_twin_bwd(pos, table, g, dtype=torch.float64, **needs, **kw)
        tab_bound = flat_table_grad_bound(pos, table, g, kw) if need_table else None
        run = lambda d: hg._flat_bwd_kernel(pos, table, g, _design=d, **needs, **kw)  # noqa: E731
        scales = [1.0] * L
    else:
        active = list(scales) if need_table else [0.0] * L
        ref_tab, ref_pos = hg._block_stochastic_twin_bwd(pos, table, g, active, need_positions=need_positions,
                                                         dtype=torch.float64, **kw)
        tab_bound = table_grad_bound(pos, table, g, active, kw) if need_table else None
        run = lambda d: hg._block_bwd_kernel(pos, table, g, scales, _design=d, **needs, **kw)  # noqa: E731
    pos_bound = position_grad_bound(g, L, F, kw["min_res"], kw["max_res"]) if need_positions else None
    designs, bad, outs = {}, [], None
    for d in hg.DESIGNS:
        d_tab, d_pos = run(d)
        torch.cuda.synchronize()
        rec = dict(table_over=0, positions_over=0, max_abs_err=0.0)
        finite = True
        if need_table:
            err = (d_tab.double() - ref_tab).abs()
            rec.update(table_over=int((err > tab_bound).sum()), max_abs_err=float(err.max()),
                       silent=all(not d_tab[l].any() for l in range(L) if not scales[l]))
            finite = finite and bool(torch.isfinite(d_tab).all())
        if need_positions:
            err = (d_pos.double() - ref_pos).abs()
            rec.update(positions_over=int((err > pos_bound).sum()),
                       max_abs_err=max(rec["max_abs_err"], float(err.max())))
            finite = finite and bool(torch.isfinite(d_pos).all())
        designs[d] = rec
        if rec["table_over"] or rec["positions_over"] or not rec.get("silent", True) or not finite:
            bad.append(d)
        outs = [t for t in (d_tab, d_pos) if t is not None]
    log(name, f"N={n} L={L} F={F} T={kw['hash_table_size']} scales={list(scales)} need_positions={need_positions} "
        f"need_table={need_table}; " + "; ".join(
            f"{d}: max |kernel - float64 twin| {r['max_abs_err']:.3g}, over the limit {r['table_over']} of d_table, "
            f"{r['positions_over']} of d_positions" + (f", scale-0 levels untouched {r['silent']}" if "silent" in r
                                                         else "") for d, r in designs.items()))
    if bad:
        raise AssertionError(f"{name}: the {bad} designs disagree with the float64 twin")
    del ref_tab, ref_pos, tab_bound
    fns = {d: (lambda d=d: run(d)) for d in hg.DESIGNS}
    if need_table:
        idx, vals = scatter_pairs(kind, pos, table, g, scales, kw)
        target = torch.zeros(table.numel(), device=table.device)
        fns["scatter alone"] = lambda: target.index_add_(0, idx, vals)
    times = paired_ms(fns)
    dev = {k: device_ms(fn) for k, fn in fns.items()}
    for d in hg.DESIGNS:
        designs[d].update(ms=times[d][0], ms_runs=times[d][1], device_ms=dev[d])
    # the table is read only for the position gradient; each gradient asked
    # is written once
    bnd = bound(nbytes(pos, g, *([table] if need_positions else []), *outs),
                hash_bwd_ops(n, L, F, need_positions))
    # the levels K7's lane groups privatise at these inputs
    private = (list(hg.bwd_plan(hg.compute_level_resolutions(L, kw["min_res"], kw["max_res"]),
                                kw["hash_table_size"], F)[0])
               if kind == "K7" and need_table and not need_positions else [])
    return dict(n=n, scales=list(scales), **needs, privatised_levels=private, bound_ms=bnd[0], bound_by=bnd[1],
                designs=designs,
                scatter_alone=(dict(ms=times["scatter alone"][0], device_ms=dev["scatter alone"], pairs=int(idx.numel()))
                               if need_table else None))


def bwd_design_line(label, rec) -> str:
    """One input set's times: events mean [two medians] / device ms."""
    parts = [f"{d} {r['ms']:.4f} {[round(m, 4) for m in r['ms_runs']]} / {r['device_ms']:.4f}"
             for d, r in rec["designs"].items()]
    if rec["scatter_alone"]:
        parts.append(f"scatter alone ({rec['scatter_alone']['pairs']} pairs) {rec['scatter_alone']['ms']:.4f} / "
                     f"{rec['scatter_alone']['device_ms']:.4f}")
    return (f"{label} (N={rec['n']}, privatised levels {rec['privatised_levels']}, bound {rec['bound_ms']:.4f} ms "
            f"by {rec['bound_by']}): " + ", ".join(parts))


def probe_inputs(gen):
    """Each probe's arguments at its script's shapes and table types, as
    {probe: {variant: args}}: fused_gather (exp/pallas_gather.py), stage1
    and stage2 (pallas_gather2.py) on bfloat16 and float32 tables; run_case
    on pallas_gather3.py's two tables, 16384 and 512 rows of float32; f4
    (gather_bench.py) on float32. Tables normal, indices uniform over the
    table's rows, slots over the row's 128/F entries, weights uniform in
    [0, 1)."""
    from nerfstudio_torch.ops import gather_probes as gp

    def table(rows, dtype=torch.float32):
        return torch.randn((rows, 128), generator=gen, device="cuda").to(dtype)

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=gen, device="cuda", dtype=torch.int32)

    def unif(shape):
        return torch.rand(shape, generator=gen, device="cuda")

    c, nb, s, f = gp.CORNERS, gp.N_BLOCKS, gp.S, gp.F
    nb2 = gp.M // 8 // gp.BLK
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return {
        "fused_gather": {k: (table(s, t), ints(s, (c, nb, s)), ints(128 // f, (c, nb, s)), unif((c, nb, s)))
                         for k, t in types.items()},
        "stage1": {k: (table(s, t), ints(s, (gp.M // gp.BLK, gp.BLK))) for k, t in types.items()},
        "stage2": {k: (table(s, t), ints(s, (nb2, c, gp.BLK)), ints(128 // f, (nb2, c, gp.BLK)),
                       unif((nb2, c, gp.BLK))) for k, t in types.items()},
        "run_case": {f"T={rows} float32": (table(rows), ints(rows, (gp.RUN_CASE_ROWS, 128)))
                     for rows in gp.RUN_CASE_TABLES},
        "f4": {"float32": (table(gp.F4_TABLE_ROWS), ints(gp.F4_TABLE_ROWS, (gp.F4_ROWS, 128)))},
    }


PROBE_REPLACES = {
    "fused_gather": "exp/pallas_gather.py:40",
    "stage1": "exp/pallas_gather2.py:41",
    "stage2": "exp/pallas_gather2.py:96",
    "run_case": "exp/pallas_gather3.py:26",
    "f4": "exp/gather_bench.py:83",
}


def check_probes(name, gen):
    """The probe entry point's main path: each probe once per variant of
    ``probe_inputs``, launch counts zeroed just before and read just after;
    then each output against its twin (exact: the same float32 operations
    in the same order, bfloat16 widened exactly) and against the one
    PyTorch call that computes the same function where there is one
    (``index_select`` for stage1's whole rows, ``torch.gather`` for
    run_case's and f4's per-lane rows; gather leaves out f4's modulo, which
    is the identity on these rows in [0, S), and takes int64 indices,
    converted before timing). run_case and f4 must take the shared-memory
    lane gather exactly where ``_lane_plan`` gives lanes (f4, run_case's
    512-row table; ``lane_gather_smem`` counts those launches) and the
    per-element kernel elsewhere (run_case's 16384-row table). Returns (launches per probe, {probe: {variant: (max abs err,
    timing, bound)}}, the inputs)."""
    from nerfstudio_torch.ops import gather_probes as gp

    inputs = probe_inputs(gen)
    fns = {k: getattr(gp, k) for k in PROBE_REPLACES}
    torch.cuda.synchronize()
    gp.reset_launch_counts()
    outs = {k: {v: fns[k](*args) for v, args in variants.items()} for k, variants in inputs.items()}
    torch.cuda.synchronize()
    launches = dict(gp.launch_counts)
    twins = {
        "fused_gather": lambda t, r, sl, w: gp._gather_select_twin(t, r.view(8, -1), sl.view(8, -1), w.view(8, -1),
                                                                   gp.F, False).view(gp.N_BLOCKS, gp.S, 128),
        "stage1": gp._row_gather_twin,
        "stage2": lambda t, r, sl, w: gp._gather_select_twin(
            t, *(x.permute(1, 0, 2).reshape(8, -1) for x in (r, sl, w)), gp.F, True),
        "run_case": lambda t, r: gp._lane_gather_twin(t, r, False),
        "f4": lambda t, r: gp._lane_gather_twin(t, r, True),
    }

    def library(k, t, r, *_):
        if k == "stage1":
            return lambda: torch.index_select(t, 0, r.view(-1))
        if k in ("run_case", "f4"):
            r64 = r.long()
            return lambda: torch.gather(t, 0, r64)
        return None

    results, lines = {}, []
    for k, variants in inputs.items():
        results[k] = {}
        for v, args in variants.items():
            out = outs[k][v]
            lib = library(k, *args)
            with torch.no_grad():
                ref = twins[k](*args)
                err = float((out.float() - ref.float()).abs().max())
                lib_err = float((lib().float() - ref.float()).abs().max()) if lib else None
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype or err != 0.0 or (lib_err is not None and lib_err != 0.0):
                raise AssertionError(f"{name}: {k} {v} disagrees with its twin ({err}) or its library call ({lib_err})")
            n_out = out.shape[0] * (out.shape[1] if out.ndim == 3 else 1)
            ops = 8 * n_out * 128 * 2 if k in ("fused_gather", "stage2") else 0  # corner multiply-adds per lane
            results[k][v] = (err, dict(kernel=lambda f=fns[k], a=args: f(*a), twin=lambda f=twins[k], a=args: f(*a),
                                       library=lib), bound(nbytes(*args, out), ops))
            lines.append(f"{k} {v} {tuple(out.shape)} {str(out.dtype)[6:]} max |kernel - twin| {err:.3g}"
                         + ("" if lib_err is None else f", library {lib_err:.3g}"))
    log(name, f"launches {launches}; " + "; ".join(lines))
    want = {k: len(v) for k, v in inputs.items()}
    want["lane_gather_smem"] = sum(1 for k in ("run_case", "f4") for tab, _ in inputs[k].values()
                                   if gp._lane_plan(tab.shape[0], tab.element_size()))
    if launches != want:
        raise AssertionError(f"{name}: probe launches {launches}, expected {want} (one per variant, run_case's "
                             "and f4's through the shared-memory lane gather where _lane_plan gives lanes)")
    del outs
    return launches, results, inputs


def lane_variants(inputs, gen):
    """(probe, variant, args) of the lane gather: run_case's and f4's
    variants of ``probe_inputs``, and f4 on its table with indices drawn over
    the whole int32 range (the script's lie in [0, S) and never take the
    modulo), the extremes INT32_MIN, INT32_MAX, -1, 0, 1, S - 1, S, -S,
    -S - 1 and 2S in its first rows."""
    out = [(k, v, args) for k in ("run_case", "f4") for v, args in inputs[k].items()]
    tab, rows = inputs["f4"]["float32"]
    s = tab.shape[0]
    wide = torch.randint(-2**31, 2**31, tuple(rows.shape), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    edges = [-2**31, 2**31 - 1, -1, 0, 1, s - 1, s, -s, -s - 1, 2 * s]
    wide[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device="cuda")[:, None]
    out.append(("f4", "float32, rows over the int32 range", (tab, wide)))
    return out


def check_lane_designs(name, inputs, gen):
    """The per-lane gather in each design on each of ``lane_variants``:
    shared-memory table columns at the most lanes per block whose columns
    fit (``_columns_that_fit``), at half and a quarter of them (more blocks
    per SM), and one thread per element; each exactly equal to the twin,
    then all timed in turns with ``torch.gather`` (int64 indices converted
    before timing; none for the full int32 range, where no single call takes
    the modulo), by CUDA events around single calls and by the profiler's
    device time. ``default`` names the design ``_lane_plan`` takes (the
    per-element kernel where the columns that fit are less than a sector of
    a row). Returns {(probe, variant): record}."""
    from nerfstudio_torch.ops import gather_probes as gp

    records, lines = {}, []
    for k, v, (tab, rows) in lane_variants(inputs, gen):
        modulo = k == "f4"
        elem = tab.element_size()
        fit = gp._columns_that_fit(tab.shape[0], elem)
        plan = gp._lane_plan(tab.shape[0], elem)
        designs = {"shared-columns": fit}
        for div in (2, 4):
            if fit // div:
                designs[f"shared-columns, {fit // div} lanes"] = fit // div
        designs["per-element"] = 0
        default = "shared-columns" if plan else "per-element"
        with torch.no_grad():
            ref = gp._lane_gather_twin(tab, rows, modulo)
            errs = {}
            for d, l in designs.items():
                out = gp._lane_gather(k, tab, rows, modulo, lanes=l)
                torch.cuda.synchronize()
                errs[d] = float((out.float() - ref.float()).abs().max())
                if out.dtype != ref.dtype or not torch.equal(out, ref):
                    raise AssertionError(f"{name}: {k} {v} ({d}, {l} lanes) differs from its twin by {errs[d]}")
            fns = {d: (lambda l=l: gp._lane_gather(k, tab, rows, modulo, lanes=l)) for d, l in designs.items()}
            in_range = "int32 range" not in v
            if in_range:
                r64 = rows.long()
                fns["torch.gather"] = lambda: torch.gather(tab, 0, r64)
            times = paired_ms(fns)
            dev = {d: device_ms(fn) for d, fn in fns.items()}
        records[(k, v)] = dict(
            lanes=plan, default=default, bound=bound(nbytes(tab, rows, ref), 0),
            library_ms=times["torch.gather"][0] if in_range else None,
            library_device_ms=dev["torch.gather"] if in_range else None,
            designs=[dict(design=d, lanes=l, max_abs_err=errs[d], ms=times[d][0], ms_runs=times[d][1],
                          device_ms=dev[d]) for d, l in designs.items()])
        lines.append(f"{k} {v} (plan {plan} lanes: {default}; events / device ms): "
                     + ", ".join(f"{d} {times[d][0]:.4f} / {dev[d]:.4f}" for d in fns) + ", all equal to the twin")
        del ref
    log(name, "; ".join(lines))
    return records


def build_neus(device, rays):
    """neus-facto at the method config (configs/method_configs.py:341-357:
    8x256 SDF net, 4x256 colour net, two L5 F2 T=2^17 proposal nets, 256/96
    proposal and 48 NeuS samples, the field and proposal optimizers),
    random weights from SEED, on bench.py's synthetic scene (16 orbit
    cameras of 128^2 random images). Returns (config, pipeline, state)."""
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam, neus_facto_optimizers
    from nerfstudio_torch.models.neus import NeuSFactoModelConfig
    from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline

    cfg = NeuSFactoModelConfig(eval_num_rays_per_chunk=NEUS_RAYS)
    model = cfg.setup(num_train_data=TRAIN_IMAGES, device=device).train()
    model.reset_parameters(torch.Generator(device=device).manual_seed(SEED))
    images = np.random.default_rng(SEED).integers(0, 255, (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW, 3)).astype(np.uint8)
    dm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=rays),
                                orbit_cameras(TRAIN_IMAGES, TRAIN_HW, device), torch.from_numpy(images), device)
    return cfg, VanillaPipeline(dm, model), TrainState(PerGroupAdam(neus_facto_optimizers(), model))


def neus_steps(cfg, pipeline, state, steps, gen):
    """The trainer's loop over ``steps``, each checked for two K7 forward
    launches (one per proposal net) and two backward, none of them in the
    backward's per-thread design. Returns the last step's metrics."""
    from nerfstudio_torch.models.neus import NeuSFactoModel
    from nerfstudio_torch.ops import hash_grid as hg

    metrics = None
    for step in steps:
        before = dict(hg.launch_counts)
        state.step = step
        metrics = pipeline.train_step(state, gen, **NeuSFactoModel.step_kwargs(step, cfg))
        got = {k: hg.launch_counts[k] - before[k] for k in NEUS_KERNELS + ("hash_encode_bwd_per_thread",)}
        if got != dict(dict.fromkeys(NEUS_KERNELS, 2), hash_encode_bwd_per_thread=0):
            raise AssertionError(f"neus-facto step {step}: launches {got}, expected two of each, none per-thread")
    return metrics


def neus_card_vs_cpu():
    """One neus-facto training step at full width on the card and on the CPU
    twins, from the card's initial weights and the same draws (pixels and
    the three rounds' jitters)."""
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.models.neus import NeuSFactoModel
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws

    gen = torch.Generator().manual_seed(SEED + 4)
    draws = StepDraws(
        torch.stack([torch.randint(0, n, (NEUS_CHECK_RAYS,), generator=gen)
                     for n in (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW)], dim=-1),
        SamplerUniforms(None, tuple(torch.rand((NEUS_CHECK_RAYS, 1), generator=gen) for _ in range(3))),
    )
    runs, weights = [], None
    for device in ("cuda", "cpu"):
        cfg, pipeline, state = build_neus(device, NEUS_CHECK_RAYS)
        if weights is None:
            weights = {k: v.detach().cpu().clone() for k, v in pipeline.model.state_dict().items()}
        pipeline.model.load_state_dict(weights)
        dev_draws = StepDraws(draws.pixels.to(device),
                              SamplerUniforms(None, tuple(u.to(device) for u in draws.sampler.rounds)))
        metrics = pipeline.train_step(state, draws=dev_draws, **NeuSFactoModel.step_kwargs(NEUS_EARLY, cfg))
        grads = {n: p.grad.detach().cpu().double() for n, p in pipeline.model.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads))
        del pipeline, state
    (m_card, g_card), (m_cpu, g_cpu) = runs
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    grad_rel = {n: float((g_card[n] - ref).abs().max() / ref.abs().max()) for n, ref in g_cpu.items()
                if ref.abs().max() > 0}
    return m_card, m_cpu, loss_rel, grad_rel


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.ops import cuda_build
    from nerfstudio_torch.ops import hash_grid as hg
    from nerfstudio_torch.ops import gather_probes as gp
    from nerfstudio_torch.ops.gsplat import _cuda as sc

    n_phases = 31
    ph = lambda i, name: f"{i}/{n_phases} {name}"  # noqa: E731

    # 1. card
    card = card_line()
    print(card, flush=True)
    log(ph(1, "card"), f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    built = cuda_build.build_all(["hash_grid", "gsplat", "gather_probes"])
    hg._kernel_library()
    sc.kernel_library()
    gp.kernel_library()
    log(ph(2, "build"), ", ".join(f"{p.name}: nvcc {s:.1f} s" for p, s in built.values())
        + f"; build+load {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # 3-6. kernels vs twins at the slices' shapes: K1 (the proposal net of the
    # render) and K3 (the field at eval), each in every design; K1 bwd (the
    # field at steady state: P=2 on levels 0, 2, 4, 6; the proposal net
    # with live proposals)
    k1_err, k1_timing, k1_bound = check_kernel(ph(3, "K1 vs twin"), False, 2_097_152, 5, 17, 2, 16, 256, gen)
    k3_err, k3_timing, k3_bound = check_kernel(ph(4, "K3 vs twin"), True, 1_048_576, 8, 19, 4, 16, 2048, gen)
    bwd_field_err, bwd_field_timing, bwd_field_bound, bwd_field_inputs = check_kernel_bwd(
        ph(5, "K1 bwd vs twin, field"), TRAIN_RAYS * 32, 8, 19, 4, 16, 2048, (2.0, 0.0) * 4, gen)
    bwd_prop_err, bwd_prop_timing, _, bwd_prop_inputs = check_kernel_bwd(
        ph(6, "K1 bwd vs twin, proposal"), TRAIN_RAYS * 64, 5, 17, 2, 16, 256, (1.0,) * 5, gen)

    # 7. the render slice: four 512^2 frames through render_camera
    model, grid = build_nerfacto("cuda")
    cams = orbit_cameras(NUM_CAMERAS, FRAME_HW, "cuda")
    chunks_per_frame = math.ceil(FRAME_HW * FRAME_HW / CHUNK)
    torch.cuda.synchronize()
    hg.reset_launch_counts()
    t0 = time.perf_counter()
    frames = [render_camera(model, None, cams, i, CHUNK, aux=grid) for i in range(NUM_FRAMES)]
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    render_launches = dict(hg.launch_counts)
    for images in frames:
        check_outputs(images, FRAME_HW)
    want = NUM_FRAMES * chunks_per_frame
    if render_launches != {"hash_encode_block": want, "hash_encode_block_exact": want, "hash_encode_block_bwd": 0,
                           "hash_encode_flat": 0, "hash_encode_flat_bwd": 0, "hash_encode_block_per_thread": 0,
                           "hash_encode_bwd_per_thread": 0}:
        raise AssertionError(f"kernel launches {render_launches}, expected {want} of each forward (one per chunk, "
                             "in the default design)")
    acc = float(torch.stack([f["accumulation"].mean() for f in frames]).mean())
    log(ph(7, "render slice"), f"{NUM_FRAMES} frames {FRAME_HW}x{FRAME_HW} in {chunks_per_frame} chunks each: "
        f"all outputs finite with the right shapes, mean accumulation {acc:.3f}, launches {render_launches}, "
        f"{slice_s:.2f} s including warm-up")

    # 8. card vs CPU twins on a 128^2 frame
    small = orbit_cameras(NUM_CAMERAS, CHECK_HW, "cuda")
    on_card = render_camera(model, None, small, 1, CHECK_HW * CHECK_HW, aux=grid)
    cpu_model = copy.deepcopy(model).cpu()
    on_cpu = render_camera(cpu_model, None, orbit_cameras(NUM_CAMERAS, CHECK_HW, "cpu"), 1,
                           CHECK_HW * CHECK_HW, aux=grid.to("cpu"))
    check_outputs(on_card, CHECK_HW)
    check_outputs(on_cpu, CHECK_HW)
    errs = {k: float((on_card[k].cpu() - on_cpu[k]).abs().mean()) for k in ("rgb", "accumulation")}
    log(ph(8, "render card vs cpu"), f"{CHECK_HW}x{CHECK_HW} frame, mean |card - cpu|: rgb {errs['rgb']:.3g}, "
        f"accumulation {errs['accumulation']:.3g} (limit {CARD_VS_CPU_MEAN_ABS}); "
        f"mean accumulation {float(on_cpu['accumulation'].mean()):.3f}")
    if not all(e <= CARD_VS_CPU_MEAN_ABS for e in errs.values()):
        raise AssertionError(f"card and CPU renders disagree: {errs}")

    # 9-10. the training slice at full width: steps 256-259 (occupancy update
    # at 256, full backward, live proposals), then steady state from 6000
    cfg, pipeline, state, hook = build_training("cuda", TRAIN_RAYS)
    train_gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    hg.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = train_steps(cfg, pipeline, state, hook, range(256, 260), train_gen)
    loss = float(metrics["loss"])
    early_s = time.perf_counter() - t0
    occupied = float(state.aux.binary.float().mean())
    if not math.isfinite(loss):
        raise AssertionError(f"training loss {loss} at step 259")
    log(ph(9, "training, steps 256-259"), f"{TRAIN_RAYS} rays/step, loss {loss:.5f} at step 259, "
        f"occupied after the update at 256: {occupied:.3f}, launches {dict(hg.launch_counts)}, "
        f"{early_s:.2f} s including warm-up")
    train_steps(cfg, pipeline, state, hook, range(STEADY_START, STEADY_START + STEADY_WARMUP), train_gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    first = STEADY_START + STEADY_WARMUP
    metrics = train_steps(cfg, pipeline, state, hook, range(first, first + STEADY_TIMED), train_gen)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / STEADY_TIMED
    loss = float(metrics["loss"])
    train_launches = dict(hg.launch_counts)
    if not math.isfinite(loss):
        raise AssertionError(f"training loss {loss} at step {first + STEADY_TIMED - 1}")
    rays_per_s = TRAIN_RAYS / (step_ms / 1e3)
    log(ph(10, "training, steady state"), f"steps {STEADY_START}-{first + STEADY_TIMED - 1} "
        f"({STEADY_WARMUP} warm-up, {STEADY_TIMED} timed): loss {loss:.5f}, psnr {float(metrics['psnr']):.2f}, "
        f"{step_ms:.2f} ms/step = {rays_per_s:,.0f} rays/s on {card} (CUDA events; host clock "
        f"{wall_s * 1e3 / STEADY_TIMED:.2f} ms/step); launches over both training runs {train_launches}")
    prof = profile_steps(cfg, pipeline, state, hook, first + STEADY_TIMED, train_gen)
    if prof is None:
        log(ph(10, "training profile"), "torch.profiler saw no device activity: device time not measured")
    else:
        rows, busy_ms, activities, gemm_flops = prof
        classes = {}
        for name, t in rows:
            classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + t
        log(ph(10, "training profile"), f"{PROFILED_STEPS} steady steps under torch.profiler: "
            f"{activities:.0f} device activities and {busy_ms:.2f} ms of device-busy time per step, i.e. "
            f"the device idles {1 - busy_ms / step_ms:.1%} of the unprofiled {step_ms:.2f} ms step; "
            "by class (ms/step): "
            + ", ".join(f"{c} {t:.3f}" for c, t in sorted(classes.items(), key=lambda kv: -kv[1])))
        for name, t in rows[:12]:
            print(f"    {t:8.3f} ms/step  {name[:110]}", flush=True)
    # K1 backward's arguments in one more steady step, an even one (its level
    # subset holds level 0), for phase 31
    cap = first + STEADY_TIMED + PROFILED_STEPS
    cap += cap % 2
    k1_step = capture_calls("_block_bwd_kernel",
                            lambda: train_steps(cfg, pipeline, state, hook, range(cap, cap + 1), train_gen))
    if len(k1_step) != 1:
        raise AssertionError(f"steady step {cap} called K1's backward {len(k1_step)} times, not once")
    del pipeline, state

    # 11. card vs CPU twins: one training step
    m_card, m_cpu, loss_rel, grad_rel, table_rel = card_vs_cpu_step()
    log(ph(11, "training card vs cpu"), f"{CHECK_RAYS} rays, full width, flat tables: loss {m_card['loss']:.6f} "
        f"vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {STEP_LOSS_RTOL}); non-table gradients max "
        f"|card - cpu| / peak {grad_rel:.3g} (limit {STEP_GRAD_REL}); table gradients per level and feature "
        f"{table_rel:.3g} of the peak (limit {STEP_TABLE_SUM_REL})")
    if loss_rel > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL or table_rel > STEP_TABLE_SUM_REL:
        raise AssertionError("card and CPU training steps disagree")

    # 12. timing (CUDA events, median of TIMED_RUNS after warm-up; twins fewer)
    with torch.no_grad():
        times = {
            "k1": median_ms(k1_timing["kernel"]), "k1_twin": median_ms(k1_timing["twin"]),
            "k3": median_ms(k3_timing["kernel"]), "k3_twin": median_ms(k3_timing["twin"]),
        }
    times["bwd_field"] = median_ms(bwd_field_timing["kernel"])
    times["bwd_field_twin"] = median_ms(bwd_field_timing["twin"], runs=5, warmup=1)
    times["bwd_prop"] = median_ms(bwd_prop_timing["kernel"])
    times["bwd_prop_twin"] = median_ms(bwd_prop_timing["twin"], runs=5, warmup=1)
    # the frame with K1 and K3 in each design, in turns (the default's mean
    # is the frame's time), and one profiled frame in each
    block_default = hg._pick_design(2)
    frame_t = paired_ms({d: (lambda d=d: render_in_design(model, grid, cams, d)) for d in hg.DESIGNS},
                        runs=10)
    frame_ms = frame_t[block_default][0]
    frame_profs = {d: profile_device(lambda d=d: render_in_design(model, grid, cams, d), per=1)
                   for d in hg.DESIGNS}
    frame_prof = frame_profs[block_default]
    frame_busy = {d: (None if fp is None else fp[1]) for d, fp in frame_profs.items()}
    block_render = capture_block_inputs(model, grid, cams)  # for phase 30
    log(ph(12, "timing"), f"on {card}: K1 {times['k1']:.3f} ms (twin {times['k1_twin']:.3f} ms), "
        f"K3 {times['k3']:.3f} ms (twin {times['k3_twin']:.3f} ms), "
        f"K1 bwd field {times['bwd_field']:.3f} ms (twin {times['bwd_field_twin']:.3f} ms), "
        f"K1 bwd proposal {times['bwd_prop']:.3f} ms (twin {times['bwd_prop_twin']:.3f} ms), "
        f"{FRAME_HW}^2 frame {frame_ms:.1f} ms = {FRAME_HW * FRAME_HW / (frame_ms / 1e3):,.0f} rays/s, "
        f"training {rays_per_s:,.0f} rays/s")
    log(ph(12, "frame by design"), f"on {card}, in turns (CUDA events, mean [two medians of 10]; profiled "
        "device-busy ms): " + ", ".join(
            f"{d} {frame_t[d][0]:.2f} {[round(m, 2) for m in frame_t[d][1]]} / "
            + ("not measured" if frame_busy[d] is None else f"{frame_busy[d]:.2f}") for d in hg.DESIGNS)
        + f"; the default is {block_default}")
    frame_idle, frame_hash = None, {}
    if frame_prof is None:
        log(ph(12, "frame profile"), "torch.profiler saw no device activity: device time not measured")
    else:
        rows, busy_ms, activities, _ = frame_prof
        frame_idle = 1 - busy_ms / frame_ms
        classes = {}
        for name, tm in rows:
            cls = hash_kernel_of(name) or kernel_class(name)
            classes[cls] = classes.get(cls, 0.0) + tm
        frame_hash = {"K1": classes.get("K1", 0.0), "K3": classes.get("K3", 0.0)}
        log(ph(12, "frame profile"), f"one {FRAME_HW}^2 frame under torch.profiler: {activities:.0f} device "
            f"activities and {busy_ms:.2f} ms of device-busy time, i.e. the device idles {frame_idle:.1%} of the "
            f"unprofiled {frame_ms:.1f} ms frame; K1 {frame_hash['K1']:.3f} ms ({frame_hash['K1'] / busy_ms:.1%} "
            f"of busy), K3 {frame_hash['K3']:.3f} ms ({frame_hash['K3'] / busy_ms:.1%}); by class (ms/frame): "
            + ", ".join(f"{c} {tm:.3f}" for c, tm in sorted(classes.items(), key=lambda kv: -kv[1])))
        for name, tm in rows[:12]:
            print(f"    {tm:8.3f} ms/frame  {name[:110]}", flush=True)
    del model, grid

    # 13-15. K4, K5, K6 vs twins at the splatfacto slice's shapes
    splat_gen = torch.Generator(device="cuda").manual_seed(SEED)
    pipeline, state = build_splat("cuda")
    x = splat_kernel_inputs(pipeline, state, splat_gen)
    k4_err, k4_timing, projected, k4_bounds = check_k4(ph(13, "K4 vs twin"), x, splat_gen)
    k5_err, k5_timing, bins, k5_bound = check_k5(ph(14, "K5 vs twin"), x, projected)
    (k6_err, k6_bwd_err), k6_timing, k6_bounds, k6_walked = check_k6(ph(15, "K6 vs twin"), x, projected, bins,
                                                                     splat_gen)
    del x, projected, bins

    # 16. the splatfacto training slice at full scale from step 6000: the
    # step, then refine with an opacity reset; warm-up; timed steps
    state.step = SPLAT_START
    alive0 = int(state.aux.alive.sum())
    torch.cuda.synchronize()
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = splat_steps(pipeline, state, 1, splat_gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    alive1 = int(state.aux.alive.sum())
    max_opac = float(torch.sigmoid(state.params["opacities"].detach()[state.aux.alive]).max())
    log(ph(16, "splatfacto training, step 6000"), f"loss {float(metrics['loss']):.5f}, refine with reset: "
        f"{alive0} -> {alive1} alive, max opacity after the reset {max_opac:.4f}, {first_s:.2f} s including warm-up")
    splat_steps(pipeline, state, SPLAT_WARMUP, splat_gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = splat_steps(pipeline, state, SPLAT_TIMED, splat_gen)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    splat_step_ms = start.elapsed_time(end) / SPLAT_TIMED
    splat_launches = {k: sc.launch_counts[k] for k in SPLAT_KERNELS}
    n_alive = int(state.aux.alive.sum())
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"splatfacto loss {loss} at step {state.step - 1}")
    log(ph(16, "splatfacto training, steady state"), f"steps {SPLAT_START + 1}-{state.step - 1} ({SPLAT_WARMUP} "
        f"warm-up, {SPLAT_TIMED} timed), {n_alive} alive of {SPLAT_SLOTS} slots, {SPLAT_HW}^2: loss {loss:.5f}, "
        f"psnr {float(metrics['psnr']):.2f}, {splat_step_ms:.2f} ms/step = "
        f"{n_alive / (splat_step_ms / 1e3):,.0f} gaussians/s on {card} (CUDA events; host clock "
        f"{wall_s * 1e3 / SPLAT_TIMED:.2f} ms/step); launches since step 6000 {splat_launches}")

    # 17. device-idle share, one refine, one 512^2 eval render
    prof = profile_device(lambda: splat_steps(pipeline, state, PROFILED_STEPS, splat_gen))
    if prof is None:
        log(ph(17, "splatfacto profile"), "torch.profiler saw no device activity: device time not measured")
    else:
        rows, busy_ms, activities, gemm_flops = prof
        classes = {}
        for name, t in rows:
            classes[kernel_class(name)] = classes.get(kernel_class(name), 0.0) + t
        log(ph(17, "splatfacto profile"), f"{PROFILED_STEPS} steady steps under torch.profiler: "
            f"{activities:.0f} device activities and {busy_ms:.2f} ms of device-busy time per step, i.e. "
            f"the device idles {1 - busy_ms / splat_step_ms:.1%} of the unprofiled {splat_step_ms:.2f} ms step; "
            "by class (ms/step): "
            + ", ".join(f"{c} {t:.3f}" for c, t in sorted(classes.items(), key=lambda kv: -kv[1])))
        for name, t in rows[:12]:
            print(f"    {t:8.3f} ms/step  {name[:110]}", flush=True)
    # K6 backward's inputs in one more steady step, for phase 28
    k6_trained = capture_k6_bwd(pipeline, state, splat_gen)
    refine_ms = median_ms(lambda: pipeline.refine(state, pipeline.refine_draws(splat_gen), do_split=True,
                                                  do_cull_scale=True, reset_alpha=False), runs=3, warmup=1)
    sc.reset_launch_counts()
    eval_metrics, out = pipeline.get_eval_image_metrics(state, 0)
    eval_launches = {k: sc.launch_counts[k] for k in SPLAT_KERNELS}
    for k, c in (("rgb", 3), ("accumulation", 1), ("depth", 1)):
        if tuple(out[k].shape) != (SPLAT_HW, SPLAT_HW, c) or not torch.isfinite(out[k]).all():
            raise AssertionError(f"eval {k}: shape {tuple(out[k].shape)} or non-finite values")
    want = dict.fromkeys(SPLAT_KERNELS, 0)
    want.update(project_gaussians=1, tile_bin=1, blend_saturating=1)
    if eval_launches != want:
        raise AssertionError(f"eval render launches {eval_launches}, expected {want}")
    frame_ms = median_ms(lambda: pipeline.render_eval_image(state, 0), runs=10, warmup=2)
    log(ph(17, "splatfacto refine and eval"), f"refine {refine_ms:.2f} ms ({int(state.aux.alive.sum())} alive "
        f"after); eval render {SPLAT_HW}^2 at sh_degree 3: {frame_ms:.2f} ms/frame, psnr "
        f"{eval_metrics['psnr']:.2f}, ssim {eval_metrics['ssim']:.4f}, launches {eval_launches}")
    del pipeline, state

    # 18. card vs CPU twins: one splatfacto step at 128^2
    l_card, l_cpu, loss_rel, grad_rel = splat_card_vs_cpu()
    log(ph(18, "splatfacto card vs cpu"), f"{SPLAT_CHECK_HW}^2, {SPLAT_CHECK_GAUSS} gaussians, sh_degree 3: loss "
        f"{l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2g}, limit {SPLAT_LOSS_RTOL}); gradients max |card - cpu| / "
        "peak " + ", ".join(f"{k} {v:.3g}" for k, v in grad_rel.items()) + f" (limit {SPLAT_GRAD_REL})")
    if loss_rel > SPLAT_LOSS_RTOL or max(grad_rel.values()) > SPLAT_GRAD_REL:
        raise AssertionError("card and CPU splatfacto steps disagree")

    # 19. the splatting kernels against their twins (twins: few runs)
    with torch.no_grad():
        t = {}
        for key, fn in (("k4", k4_timing["fwd"]), ("k5", k5_timing["kernel"]), ("k6", k6_timing["fwd"])):
            t[key] = median_ms(fn)
        for key, fn in (("k4_twin", k4_timing["fwd_twin"]), ("k5_twin", k5_timing["twin"]),
                        ("k6_twin", k6_timing["fwd_twin"])):
            t[key] = median_ms(fn, runs=3, warmup=1)
    t["k4_bwd"] = median_ms(k4_timing["bwd"])
    t["k6_bwd"] = median_ms(k6_timing["bwd"])
    k6_bwd_check_fn = k6_timing["bwd"]
    t["k4_bwd_twin"] = median_ms(k4_timing["bwd_twin"], runs=3, warmup=1)
    t["k6_bwd_twin"] = median_ms(k6_timing["bwd_twin"], runs=3, warmup=1)
    t["k5_sort"] = median_ms(k5_timing["library"])
    log(ph(19, "splatting timing"), f"on {card}: " + ", ".join(
        f"{k} {t[k]:.3f} ms (twin {t[k + '_twin']:.3f} ms)" for k in ("k4", "k4_bwd", "k5", "k6", "k6_bwd"))
        + f"; K5's torch.sort alone {t['k5_sort']:.3f} ms; splatfacto step {splat_step_ms:.2f} ms, refine "
        f"{refine_ms:.2f} ms, eval frame {frame_ms:.2f} ms")
    del k4_timing, k5_timing, k6_timing

    # 20-21. K7 forward and backward vs twins at the proposal nets' shapes:
    # round 1 (256 samples per ray) and round 2 (96)
    k7, k7_bwd_inputs = {}, {}
    for i, samples in enumerate(NEUS_SAMPLES):
        n = NEUS_RAYS * samples
        k7[f"fwd_{samples}"] = check_flat(ph(20, f"K7 vs twin, {samples} samples/ray"), n, gen)
        *k7[f"bwd_{samples}"], k7_bwd_inputs[samples] = check_flat_bwd(
            ph(21, f"K7 bwd vs float64 twin, {samples} samples/ray"), n, gen)

    # 22. the gather probes' entry point at the probes' own shapes
    probe_launches, probes, probe_args = check_probes(ph(22, "gather probes"), gen)

    # 23. the neus-facto training slice at full width: steps 300-301, then
    # steady state from 6000 (launches zeroed before, read after)
    cfg, pipeline, state = build_neus("cuda", NEUS_RAYS)
    neus_gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    hg.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = neus_steps(cfg, pipeline, state, range(NEUS_EARLY, NEUS_EARLY + 2), neus_gen)
    torch.cuda.synchronize()
    early_s = time.perf_counter() - t0
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"neus-facto loss {loss} at step {NEUS_EARLY + 1}")
    log(ph(23, "neus-facto training, steps 300-301"), f"{NEUS_RAYS} rays/step, loss {loss:.5f} (eikonal "
        f"{float(metrics['eikonal_loss']):.5f}, interlevel {float(metrics['interlevel_loss']):.5f}), "
        f"{early_s:.2f} s including warm-up")
    neus_steps(cfg, pipeline, state, range(NEUS_START, NEUS_START + NEUS_WARMUP), neus_gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    first = NEUS_START + NEUS_WARMUP
    metrics = neus_steps(cfg, pipeline, state, range(first, first + NEUS_TIMED), neus_gen)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    neus_step_ms = start.elapsed_time(end) / NEUS_TIMED
    neus_launches = {k: hg.launch_counts[k] for k in NEUS_KERNELS}
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"neus-facto loss {loss} at step {first + NEUS_TIMED - 1}")
    neus_rays_per_s = NEUS_RAYS / (neus_step_ms / 1e3)
    log(ph(23, "neus-facto training, steady state"), f"steps {NEUS_START}-{first + NEUS_TIMED - 1} "
        f"({NEUS_WARMUP} warm-up, {NEUS_TIMED} timed): loss {loss:.5f}, psnr {float(metrics['psnr']):.2f}, "
        f"{neus_step_ms:.2f} ms/step = {neus_rays_per_s:,.0f} rays/s on {card} (CUDA events; host clock "
        f"{wall_s * 1e3 / NEUS_TIMED:.2f} ms/step); launches over both training runs {neus_launches}")

    # 24. device-idle share of the neus-facto step
    prof = profile_device(lambda: neus_steps(cfg, pipeline, state, range(first + NEUS_TIMED,
                                                                          first + NEUS_TIMED + PROFILED_STEPS),
                                             neus_gen))
    neus_idle = None
    if prof is None:
        log(ph(24, "neus-facto profile"), "torch.profiler saw no device activity: device time not measured")
    else:
        rows, busy_ms, activities, gemm_flops = prof
        neus_idle = 1 - busy_ms / neus_step_ms
        classes = {}
        for name, tm in rows:
            cls = "K7 (flat hash grid)" if is_k7(name) else kernel_class(name)
            classes[cls] = classes.get(cls, 0.0) + tm
        log(ph(24, "neus-facto profile"), f"{PROFILED_STEPS} steady steps under torch.profiler: "
            f"{activities:.0f} device activities and {busy_ms:.2f} ms of device-busy time per step, i.e. "
            f"the device idles {neus_idle:.1%} of the unprofiled {neus_step_ms:.2f} ms step; by class (ms/step): "
            + ", ".join(f"{c} {tm:.3f}" for c, tm in sorted(classes.items(), key=lambda kv: -kv[1]))
            + f"; matrix products {gemm_flops / 1e9:.1f} GFLOP per step (profiler count), i.e. "
            + (f"{gemm_flops / (classes['GEMMs'] * 1e-3) / 1e12:.1f} TFLOP/s over the GEMM class"
               if classes.get("GEMMs") else "no GEMM class"))
        for name, tm in rows[:12]:
            print(f"    {tm:8.3f} ms/step  {name[:110]}", flush=True)
    # both K7 backward calls of one more steady step, for phase 31
    cap = first + NEUS_TIMED + PROFILED_STEPS
    k7_step = capture_calls("_flat_bwd_kernel", lambda: neus_steps(cfg, pipeline, state, range(cap, cap + 1), neus_gen))
    if len(k7_step) != 2:
        raise AssertionError(f"neus-facto step {cap} called K7's backward {len(k7_step)} times, not twice")

    # 25. one 512^2 eval frame through render_camera, 2048-ray chunks
    model = pipeline.model.eval()
    cams = orbit_cameras(NUM_CAMERAS, FRAME_HW, "cuda")
    chunks = math.ceil(FRAME_HW * FRAME_HW / NEUS_RAYS)
    torch.cuda.synchronize()
    hg.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    frame = render_camera(model, None, cams, 0, NEUS_RAYS)
    end.record()
    end.synchronize()
    neus_frame_ms = start.elapsed_time(end)
    eval_launches = {k: hg.launch_counts[k] for k in NEUS_KERNELS}
    for k, c in (("rgb", 3), ("accumulation", 1), ("depth", 1), ("normals", 3)):
        if tuple(frame[k].shape) != (FRAME_HW, FRAME_HW, c) or not torch.isfinite(frame[k]).all():
            raise AssertionError(f"neus-facto eval {k}: shape {tuple(frame[k].shape)} or non-finite values")
    if eval_launches != {"hash_encode_flat": 2 * chunks, "hash_encode_flat_bwd": 0}:
        raise AssertionError(f"neus-facto eval launches {eval_launches}, expected {2 * chunks} forward, no backward")
    normal_len = float(torch.linalg.norm(frame["normals"], dim=-1).mean())
    first_frame_ms = neus_frame_ms
    neus_frame_ms = median_ms(lambda: render_camera(model, None, cams, 1, NEUS_RAYS), runs=1, warmup=0)
    log(ph(25, "neus-facto eval frame"), f"{FRAME_HW}^2 in {chunks} chunks of {NEUS_RAYS}: {neus_frame_ms:.1f} ms "
        f"(second frame, CUDA events; the first, with warm-up, {first_frame_ms:.1f} ms), mean accumulation "
        f"{float(frame['accumulation'].mean()):.3f}, mean |normal| {normal_len:.3f}, launches {eval_launches}")
    del pipeline, state, model, frame

    # 26. card vs CPU twins: one neus-facto step
    m_card, m_cpu, loss_rel, grad_rel = neus_card_vs_cpu()
    worst = max(grad_rel, key=grad_rel.get)
    log(ph(26, "neus-facto card vs cpu"), f"{NEUS_CHECK_RAYS} rays of {TRAIN_HW}^2 images, full width: loss "
        f"{m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {NEUS_LOSS_RTOL}); gradients max "
        f"|card - cpu| / peak {grad_rel[worst]:.3g} at {worst} (limit {NEUS_GRAD_REL})")
    if loss_rel > NEUS_LOSS_RTOL or grad_rel[worst] > NEUS_GRAD_REL:
        raise AssertionError("card and CPU neus-facto steps disagree")

    # 27. K7 and the probes against their twins and library calls
    for key, (_, timing, _) in k7.items():
        t[f"k7_{key}"] = median_ms(timing["kernel"])
        t[f"k7_{key}_twin"] = median_ms(timing["twin"], runs=3, warmup=1)
    probe_t = {}  # probe -> variant -> kernel, twin and library ms
    with torch.no_grad():
        for key, variants in probes.items():
            for v, (_, timing, _) in variants.items():
                probe_t.setdefault(key, {})[v] = dict(
                    ms=median_ms(timing["kernel"]), plain_ms=median_ms(timing["twin"], runs=3, warmup=1),
                    library_ms=median_ms(timing["library"]) if timing["library"] else None)
    log(ph(27, "neus-facto timing"), f"on {card}: " + ", ".join(
        f"K7 {k.replace('_', ' ')} samples/ray {t['k7_' + k]:.3f} ms (twin {t['k7_' + k + '_twin']:.3f} ms)"
        for k in k7) + "; " + ", ".join(
        f"{k} {v} {pt['ms']:.3f} ms (twin {pt['plain_ms']:.3f} ms, library "
        + ("none" if pt["library_ms"] is None else f"{pt['library_ms']:.3f} ms") + ")"
        for k, variants in probe_t.items() for v, pt in variants.items())
        + f"; neus-facto step {neus_step_ms:.2f} ms = {neus_rays_per_s:,.0f} rays/s, idle "
        + ("not measured" if neus_idle is None else f"{neus_idle:.1%}") + f", eval frame {neus_frame_ms:.1f} ms")

    # 28. K6 backward at the check inputs and at the inputs of one
    # trained-state step (captured after phase 17)
    m2, con, ch, op, tb, T, last, g_ch = k6_trained
    tr_rel, tr_err, tr_fn, tr_bound, tr_walked = k6_bwd_check(m2, con, ch, op, tb, T, last, g_ch)
    k6_t = paired_ms({"check": k6_bwd_check_fn, "trained": tr_fn})
    k6_dev = {"check": device_ms(k6_bwd_check_fn), "trained": device_ms(tr_fn)}
    log(ph(28, "K6 backward, trained state"), f"on {card}: trained state ({tb.tiles_x * 16}x{tb.tiles_y * 16}, "
        f"{int(tb.counts.sum())} entries in tiles, max {int(tb.counts.max())} per tile, walked {tr_walked:.0f}, "
        f"bound {tr_bound[0]:.4f} ms by {tr_bound[1]}): " + k6_bwd_line(tr_rel) + "; times (two medians each) "
        f"{k6_t['trained'][0]:.4f} ms {k6_t['trained'][1]} (device {k6_dev['trained']:.4f}); check inputs "
        f"(walked {k6_walked:.0f}, bound {k6_bounds[1][0]:.4f} ms): {k6_t['check'][0]:.4f} ms {k6_t['check'][1]} "
        f"(device {k6_dev['check']:.4f})")
    if max(tr_rel.values()) > K6_BWD_REL:
        raise AssertionError("K6 backward disagrees with its twin at the trained state")
    del k6_trained, m2, con, ch, op, tb, T, last, g_ch, tr_fn, k6_bwd_check_fn

    # 29. the per-lane gather (run_case, f4), every design on every variant
    lane = check_lane_designs(ph(29, "lane gather designs"), probe_args, gen)
    del probe_args

    # 30. K1 and K3, every design against the twin at the inputs of one
    # render chunk (captured in phase 12), then every design timed in turns
    # at the check inputs (phases 3-4) and at the render chunk's
    render_checks, render_twin_ms, block_t, lines = {}, {}, {}, []
    for exact, check_timing in ((False, k1_timing), (True, k3_timing)):
        label = "K3" if exact else "K1"
        pos, table, kw = block_render[exact]
        L, S, _ = table.shape
        render_checks[exact] = check_block_designs(
            ph(30, f"{label} designs, render inputs"), exact, pos, table, kw,
            f"one {FRAME_HW}^2 chunk: N={pos.shape[0]} L={L} F={128 * S // kw['hash_table_size']} "
            f"T={kw['hash_table_size']} max_res={kw['max_res']}")
        with torch.no_grad():
            render_twin_ms[exact] = median_ms(render_checks[exact][1]["twin"], runs=3, warmup=1)
        for inputs, timing in (("check", check_timing), ("render", render_checks[exact][1])):
            block_t[(exact, inputs)] = ev, dev = time_block_designs(timing)
            lines.append(f"{label} at the {inputs} inputs: " + ", ".join(
                f"{d} {ev[d][0]:.4f} {ev[d][1]} / {dev[d]:.4f}" for d in hg.DESIGNS))
    block_n = {exact: inputs[0].shape[0] for exact, inputs in block_render.items()}
    del block_render
    log(ph(30, "K1 and K3 designs, timing"), f"on {card} (events: mean [two medians] / device ms); "
        + "; ".join(lines) + f"; default at F=2 and 4: {hg._pick_design(2)}")

    # 31. K1's and K7's backward, every design against the float64 twin and
    # timed in turns, at the check inputs (phases 5, 6 and 21) and at the
    # inputs captured from one steady nerfacto step and one neus-facto step
    bwd_sets = {"K1": [("check, field", *bwd_field_inputs, (2.0, 0.0) * 4, {}),
                       ("check, proposal", *bwd_prop_inputs, (1.0,) * 5, {})],
                "K7": [(f"check, {s} samples/ray", *k7_bwd_inputs[s], None, {}) for s in NEUS_SAMPLES]}
    for kind, calls in (("K1", k1_step), ("K7", k7_step)):
        for c, (args, kwargs) in enumerate(calls):
            pos, table, g, *scales = args
            kw = dict(kwargs)
            needs = {k: kw.pop(k) for k in ("need_positions", "need_table")}
            label = "nerfacto step" if kind == "K1" else f"neus-facto step, call {c + 1}"
            bwd_sets[kind].append((label, pos, table, g, kw, scales[0] if scales else None, needs))
    del k1_step, k7_step, bwd_field_inputs, bwd_prop_inputs, k7_bwd_inputs
    bwd_recs, lines = {"K1": {}, "K7": {}}, []
    for kind, sets in bwd_sets.items():
        for label, pos, table, g, kw, scales, needs in sets:
            rec = check_bwd_designs(ph(31, f"{kind} bwd designs, {label}"), kind, pos, table, g, kw, scales, **needs)
            bwd_recs[kind][label] = rec
            lines.append(bwd_design_line(f"{kind} bwd at the {label} inputs", rec))
    del bwd_sets
    log(ph(31, "K1 bwd and K7 bwd designs, timing"), f"on {card} (events: mean [two medians] / device ms); "
        + "; ".join(lines) + f"; default at F=2 and 4: {hg._pick_design(2)}")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms=None, design="first"):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, "design": design}

    source = "nerfstudio_torch/csrc/hash_grid.cu"
    gs_source = "nerfstudio_torch/csrc/gsplat.cu"
    hash_launch = {k: render_launches[k] + train_launches[k] for k in render_launches}

    def block_entry(name, replaces, exact, features, errs, bnd, twin_ms):
        """K1's or K3's entry in its default design, with every design at the
        check and the render inputs, and the render inputs' own record."""
        default = hg._pick_design(features)
        (ct, cdev), (rt, rdev) = block_t[(exact, "check")], block_t[(exact, "render")]
        r_errs, _, r_bnd = render_checks[exact]
        key = "hash_encode_block_exact" if exact else "hash_encode_block"
        e = entry(name, source, replaces, hash_launch[key], errs[default], ct[default][0], twin_ms, bnd,
                  design=default)
        e["device_ms"] = cdev[default]
        e["designs"] = [dict(design=d, ms=ct[d][0], ms_runs=ct[d][1], device_ms=cdev[d], max_abs_err=errs[d],
                             render_ms=rt[d][0], render_ms_runs=rt[d][1], render_device_ms=rdev[d],
                             render_max_abs_err=r_errs[d]) for d in hg.DESIGNS]
        e["render"] = dict(n=int(block_n[exact]), ms=rt[default][0], device_ms=rdev[default],
                           plain_ms=render_twin_ms[exact], bound_ms=r_bnd[0], bound_by=r_bnd[1],
                           max_abs_err=r_errs[default], frame_ms=frame_hash.get("K3" if exact else "K1"),
                           frames=[dict(design=d, ms=frame_t[d][0], ms_runs=frame_t[d][1], busy_ms=frame_busy[d])
                                   for d in hg.DESIGNS])
        return e

    kernels = [
        block_entry("hash_encode_block (K1 fwd)", "nerfstudio_tpu/ops/hash_grid.py:352", False, 2, k1_err,
                    k1_bound, times["k1_twin"]),
        block_entry("hash_encode_block_exact (K3)", "nerfstudio_tpu/ops/hash_grid.py:696", True, 4, k3_err,
                    k3_bound, times["k3_twin"]),
        entry("hash_encode_block_bwd (K1 bwd + K2), field shape", source, "nerfstudio_tpu/ops/hash_grid.py:439",
              hash_launch["hash_encode_block_bwd"], max(bwd_field_err, bwd_prop_err), times["bwd_field"],
              times["bwd_field_twin"], bwd_field_bound, design=hg._pick_design(4)),
        entry("project_gaussians (K4 fwd)", gs_source, "nerfstudio_tpu/ops/gsplat/projection.py:39",
              splat_launches["project_gaussians"], k4_err, t["k4"], t["k4_twin"], k4_bounds[0]),
        entry("project_gaussians_bwd (K4 bwd)", gs_source, "nerfstudio_tpu/ops/gsplat/projection.py:39",
              splat_launches["project_gaussians_bwd"], k4_err, t["k4_bwd"], t["k4_bwd_twin"], k4_bounds[1]),
        entry("tile_bin (K5)", gs_source, "nerfstudio_tpu/ops/gsplat/rasterize.py:266", splat_launches["tile_bin"],
              k5_err, t["k5"], t["k5_twin"], k5_bound, t["k5_sort"]),
        entry("blend_saturating (K6 fwd)", gs_source, "nerfstudio_tpu/ops/gsplat/rasterize.py:94",
              splat_launches["blend_saturating"], k6_err, t["k6"], t["k6_twin"], k6_bounds[0]),
        entry("blend_saturating_bwd (K6 bwd)", gs_source, "nerfstudio_tpu/ops/gsplat/rasterize.py:142",
              splat_launches["blend_saturating_bwd"], k6_bwd_err, k6_t["check"][0], t["k6_bwd_twin"], k6_bounds[1],
              design="block-reduced"),
    ]
    # K6 backward: the check inputs' walk, and the trained state's
    kernels[-1].update(
        walked=k6_walked, device_ms=k6_dev["check"],
        trained={"walked": tr_walked, "ms": k6_t["trained"][0], "device_ms": k6_dev["trained"],
                 "bound_ms": tr_bound[0], "bound_by": tr_bound[1], "max_abs_err": tr_err})
    big = f"fwd_{NEUS_SAMPLES[0]}"
    kernels.append(entry("hash_encode_flat (K7 fwd), 256 samples/ray", source, "nerfstudio_tpu/ops/hash_grid.py:63",
                         neus_launches["hash_encode_flat"], max(k7[k][0] for k in k7 if k.startswith("fwd")),
                         t["k7_" + big], t["k7_" + big + "_twin"], k7[big][2]))
    big = f"bwd_{NEUS_SAMPLES[0]}"
    kernels.append(entry("hash_encode_flat_bwd (K7 bwd), 256 samples/ray", source,
                         "nerfstudio_tpu/ops/hash_grid.py:90", neus_launches["hash_encode_flat_bwd"],
                         max(k7[k][0] for k in k7 if k.startswith("bwd")), t["k7_" + big],
                         t["k7_" + big + "_twin"], k7[big][2], design=hg._pick_design(2)))
    # the backward entries: every design at every input set of phase 31, the
    # input sets (bound, the "scatter alone" yardstick), and the steps' own
    for e, kind in ((kernels[2], "K1"), (kernels[-1], "K7")):
        recs = bwd_recs[kind]
        default = e["design"]
        e["device_ms"] = next(iter(recs.values()))["designs"][default]["device_ms"]
        e["designs"] = [dict(design=d, inputs=[dict(inputs=label, n=r["n"], **r["designs"][d])
                                               for label, r in recs.items()]) for d in hg.DESIGNS]
        e["inputs"] = [dict(inputs=label, **{k: v for k, v in r.items() if k != "designs"})
                       for label, r in recs.items()]
        e["step"] = [dict(inputs=label, n=r["n"], ms=r["designs"][default]["ms"],
                          device_ms=r["designs"][default]["device_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], scatter_alone=r["scatter_alone"],
                          designs={d: dict(ms=x["ms"], device_ms=x["device_ms"]) for d, x in r["designs"].items()})
                     for label, r in recs.items() if "step" in label]
    # one entry per probe: its first float32 variant's times, the largest
    # error and every launch over its variants; "variants" lists them all
    # run_case's and f4's variants add their designs (phase 29), and f4 its
    # variant over the int32 range, which the main path does not run
    def default_of(r):  # the record of the design _lane_plan takes
        return next(d for d in r["designs"] if d["design"] == r["default"])

    for k, variants in probes.items():
        main_v = next(v for v in variants if "float32" in v)
        pt = probe_t[k][main_v]
        design_of = lambda v: lane[(k, v)]["default"] if (k, v) in lane else "first"  # noqa: E731
        e = entry(f"{k} (probe), {main_v}", "nerfstudio_torch/csrc/gather_probes.cu", PROBE_REPLACES[k],
                  probe_launches[k], max(err for err, _, _ in variants.values()), pt["ms"], pt["plain_ms"],
                  variants[main_v][2], pt["library_ms"], design=design_of(main_v))
        designs_of = lambda r: dict(lanes=r["lanes"], device_ms=default_of(r)["device_ms"],  # noqa: E731
                                    library_device_ms=r["library_device_ms"], designs=r["designs"])
        e["variants"] = [dict(variant=v, max_abs_err=err, bound_ms=bnd[0], bound_by=bnd[1], design=design_of(v),
                              **probe_t[k][v], **(designs_of(lane[(k, v)]) if (k, v) in lane else {}))
                         for v, (err, _, bnd) in variants.items()]
        e["variants"] += [dict(variant=v, max_abs_err=default_of(r)["max_abs_err"], bound_ms=r["bound"][0],
                               bound_by=r["bound"][1], design=r["default"], ms=default_of(r)["ms"],
                               library_ms=r["library_ms"], **designs_of(r))
                          for (kk, v), r in lane.items() if kk == k and v not in variants]
        if (k, main_v) in lane:
            e["device_ms"] = default_of(lane[(k, main_v)])["device_ms"]
            e["library_device_ms"] = lane[(k, main_v)]["library_device_ms"]
        kernels.append(e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
