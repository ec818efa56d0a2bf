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
  (phases 13-19): K4 forward and backward (device time too), K5 and K6
  forward and backward
  against their twins at 100,000 slots and 512^2 (K5 in both designs,
  tile-bucketed and sorted, at the check inputs, with one tile longer
  than one block of the bucketed sort orders at once, and at one trained
  step's own inputs, then timed in turns beside torch.sort of the live
  keys and of all the slots' keys); training through
  ``SplatPipeline.train``'s schedule from step 6000 (the step, refine with
  an opacity reset, 5 warm-up and 30 timed steps, one launch of each of the
  five kernels checked per step, in their default designs); a profile of
  three steps and of one 512^2 eval render, each with one row per gsplat
  kernel, one refine and the eval render timed; one 128^2 step on the card
  against the CPU twins;
* neus-facto at the shipped config (phases 20-27): K7 forward and backward
  against their twins (the backward against a float64 run) at the proposal
  nets' shapes, the forward in every design, also at both calls of one
  eval frame chunk, and timed in turns; the five gather probes at their own shapes through their
  entry points, against their twins and their PyTorch library calls;
  training on bench.py's scene at 2048 rays (steps 300-301, then warm-up
  and timed steps from 6000, two K7 forward and two backward launches
  checked per step), a profile of three steps, one 512^2 eval frame through
  ``render_camera`` (timed with K7's forward in each design in turns, and
  profiled by kernel class) and one step on the card against the CPU
  twins;
* K6's backward at the inputs of one trained-state splat step (phase 28);
* K6's forward in both designs (phase 32), culled per warp and per pixel:
  bit-equal to each other (out, T and last), each against the twin, and
  timed in turns, at the check inputs, with one long tile and at a
  trained step's inputs, with the share of (warp, staged entry) pairs the
  culled design skips;
* the kernels with more than one design (phases 29-30), each design
  against the twin and timed in turns on the same inputs: the per-lane
  gather of run_case and f4 (shared-memory table columns at the lanes that
  fit and at fewer, and one thread per element) at every variant of the
  probes and at f4 with indices over the whole int32 range; K1's forward
  and K3 (lane groups, one thread per stencil) at the check inputs and at
  the captured inputs of a render chunk;
* the gather-select of fused_gather and stage2 in both designs (phase 33),
  one warp per output row and one thread per output element: each
  ``torch.equal`` to the twin and bit-equal to the other at the four probe
  variants, bit-equal to each other at edge inputs (rows and slots over the
  int32 range, NaN, infinite and negative weights, F = 1, 2, 8, 16 and
  128, a block and an n that are not multiples of 32, 3 corners), and timed
  in turns (50 calls back to back, single calls, profiler records);
* K1's and K7's backward in both designs (phase 31): one thread per sample,
  and lane groups with vector reductions (K7's, asked for the table
  gradient alone as a neus-facto step asks, with the dense coarse levels
  privatised in shared memory), each against the float64 twin and timed in
  turns beside the "scatter alone" yardstick (``index_add_`` of the same
  (entry, value) pairs), at the check inputs of phases 5, 6 and 21 and at
  the inputs captured from one steady nerfacto step and from both K7
  backward calls of one steady neus-facto step;
* K5 at a frame above the bucketed design's tile limit (phase 14: 4096x4352,
  69,632 tiles) through the default routing, which must take the sorted
  design and equal the twin exactly;
* training from a scene on disk through the user's entry points (phases
  34-38): tools/make_synthetic_dataset.py's ``basic`` scene at the JAX
  gate records' protocol (48 frames of 200^2), ``scripts.train`` nerfacto
  for 300 steps with a save at 150, a resume to 400, the eval of the first
  save and ``scripts.eval`` of the end (the PSNR must rise); the nerfacto
  and splatfacto gate runs through ``scripts.gate``, cut in depth to 600
  of their 5000 and 8000 steps (the loss must fall; their full runs stand
  in PERF.md), beside the JAX records' quality; neus-facto for 200 steps
  through the trainer (the loss must fall). Each
  path's kernel launches are zeroed before it and read after; each must
  launch its kernels. Then every kernel of each path is held against its
  twin at the inputs of one more step from its trained state (nerfacto's
  K3 at one eval chunk's), at the tolerances of the phases above, and the
  gates' device idle share is profiled over 3 more steps;
* captures beyond the clean pinhole (phases 39-46): every camera type's
  rays on the card against the CPU (perspective with all six OpenCV terms,
  fisheye, equirectangular, ODS and VR180 left and right, orthophoto,
  Fisheye624 with 12 terms, and one batch mixing the types; a 512^2 image
  each, then random pixels without and with a camera-opt pose and a
  distortion delta per ray); every sampling path on the card against the
  CPU with the CPU's draws handed in, exact (the fisheye, equirectangular,
  patch and pair samplers, the masked table, masked, bucketed and
  masked-bucket batches, a resident subset before and after a reload);
  the tool's ``distorted`` and ``masked`` scenes and a mixed-resolution
  masked scene (the masked one beside a 120^2 render); the nerfacto and
  splatfacto gates on ``distorted`` and ``masked`` at their full steps,
  each beside its JAX record and followed by its path's kernels against
  their twins at its trained state (the host time of undistorting the
  splat train images too); and 200 nerfacto steps through the resolution
  buckets of the mixed-resolution masked scene (the loss must fall), with
  one step on the card against the CPU twins. The four gates on
  ``distorted`` and ``masked`` run 600 of their 8000 or 5000 steps (cut in
  depth): their loss must fall, and every kernel of each path holds at its
  trained state;
* splatfacto's options and methods (phases 47-52): K4's backward with the
  viewmat gradient (camera optimisation) against a float64 run of the twin
  at the check inputs, at 1,000,000 random slots and at one trained MCMC
  step's inputs (bit-equal across two runs), timed in turns beside the
  default backward; K8 (``grid_sample_1d/2d/3d``, ``resize_linear``) and the
  bilateral slice with their gradients and one ``color_correct`` on the card
  against the CPU; one MCMC step (its noise draw handed in), one step with
  the bilateral grid, SO3xR3 camera optimisation and scale regularisation
  (the grids' and tangents' gradients compared too) and one MCMC refine, slot
  for slot with the CPU's draws, on the card against the CPU; the
  splatfacto-mcmc and splatfacto-big gate runs on ``basic`` at 1,000,000
  slots, cut in depth to 600 of their 8000 steps (the loss must fall; their
  full runs stand in PERF.md), each followed by its path's kernels against
  their twins at its trained state and its idle share; splatfacto with the
  three options on for 400 steps through ``scripts.gate``'s loop (the loss
  must fall, the tangents stay finite, every step launches the viewmat
  backward, the eval colour-corrects);
* the largest ray methods and plain NeuS (phases 53-57): one nerfacto-huge
  step at 1024 rays and the shipped width (field L16 F4 T=2^21, a 512 MiB
  table, 256-wide MLPs; an L7 proposal net) on the card against the CPU
  twins; the nerfacto-huge gate (1500 steps, 16,384 rays) and the
  nerfacto-big run (1000 of its gate's 3000 steps, 8192 rays: its loss
  must fall) on ``basic`` at full width beside the JAX records, each
  followed by K1's forward (the step's proposal and field
  calls, the proposal's at an eval chunk) and backward (both calls) and K3
  (one eval chunk of 32,768 rays) at its trained state, every design
  against its twin and timed (CUDA events in turns, device time, 50 calls
  back to back) beside a bound that reads each touched 128-byte table line
  once, and by a 3-step profile (idle share, the hash grid's share, rays/s);
  one plain-neus step (the sampler's draws handed in) and one eval chunk on
  the card against the CPU; plain neus on the ``blender`` scene through the
  Blender parser, cut in depth to 300 of its gate's 12,000 steps (the loss
  must fall; the PSNR stands beside the JAX record), and its idle share;
* the rest of the nerfacto family (phases 58-60), each through
  ``scripts.gate``'s loop at its shipped config, cut in depth to 300 of its
  gate's 5000 steps: depth-nerfacto on ``basic`` with the SfM depth of its
  30,000 seed points, semantic-nerfw on the tool's ``semantic`` scene and
  phototourism on ``appearance`` (both beside ``basic``, made while the
  earlier phases run; neither has nerfacto's speed knobs, so K1's backward
  runs over every field level and the proposal's on every step). The rgb
  loss and the method's own term (the depth or the semantic loss) must
  fall; then, at the trained state, K1's forward and backward at one more
  step's calls and K3 at one eval chunk against the twins, one step of the
  trained model (its tables set flat) on the card against the CPU twins
  with the same draws, every loss term compared, and a 3-step profile
  (idle share, the hash grid's share, launches per step); phototourism's
  kernels are also timed there, as nerfacto-huge's are;
* the Blender-protocol methods (phases 61-63): first a double backward
  through K1 on the card against its float64 twin (K1bb), and through K7,
  K4 and K6, which must raise (their backwards are once differentiable);
  then through ``scripts.gate``'s loop on the
  ``blender`` scene of phase 57, at their shipped configs: tensorf cut to
  2200 of its 5000 steps, through its first grid upsample (step 2000, R 128
  -> 152, the optimizer re-initialised: the loss must fall before it and
  again after it, the grids must be at 152 and the optimizer's count must
  have restarted there), vanilla-nerf and mipnerf cut to 300 of their 8000
  steps (both passes' rgb losses must fall). None launches a hand-written
  kernel. At each trained state one step (256 rays, the draws handed in,
  the MLPs' products in float32) on the card against the CPU, every loss
  term and gradient compared, one 1024-ray eval chunk under the white
  background override against the CPU, and a 3-step profile by class;
  K8 (plain PyTorch) at tensorf's step's own 18 calls, replayed alone:
  events and profiler time, launches, bound, share of the busy step;
* instant-ngp (phase 64, scene contraction, 500 steps past its 256-step
  grid warm-up: ~15 whole-grid refreshes) and instant-ngp-bounded (phase
  65, 300 steps, over black) through ``scripts.gate``'s loop on the
  ``blender`` scene at their shipped configs (4096 rays of 48 samples,
  128 occupancy probes a ray on a 128^3 grid, an L8 F4 T=2^19 field): the
  loss must fall; at the trained state K1's forward and backward at one
  more step's calls, K3 at one 8192-ray eval chunk and K1's forward at one
  whole-grid refresh (2,097,152 cells) against the twins and timed; the
  refresh on the card against the CPU (the same jitter, the MLPs in
  float32); one step (flat tables, the MLPs in float32, the PDF jitter and
  the random background handed in) and one eval chunk card vs CPU; a
  3-step profile (idle share, the hash grid's share) and K3's share of a
  profiled eval chunk;
* nerfacto's sampling options (phase 66): one full-width step on the card
  against the CPU twins without the occupancy sampler (both proposal nets)
  and with the grid's PDF alone over its EMA densities
  (``num_proposal_iterations=0``, ``occ_weight_mode="density"``);
* nerfacto with ``predict_normals`` (phase 67): K3b (K3's position
  gradient, the eval normals) at an eval chunk's field samples and K1bb
  (K1's backward differentiated again, the normals' loss) at a step's, at
  both phases of the period-2 level cycle, each in both designs against
  its float64 twin within float32 summation bounds, the default design
  (lane groups) run twice (K3b's d_pos, K1bb's d_grad and d_pos
  bit-equal), and both designs timed in turns; then the cell through
  ``scripts.gate``'s loop on ``basic`` with ``--model.predict-normals
  True``, cut to 800 of its 5000 steps (the loss must fall, and both normal
  terms from the run's second quarter; no per-thread K3b or K1bb launched);
  at the trained state K3b and K1bb at one eval chunk's and one step's
  inputs, checked and timed as above, one step card vs CPU (tables
  constant on the coin's vertex pairs, MLPs in float32, the CPU's hash
  encodings at the card's positions, which must lie within POSITION_GAP of
  its own: every loss term, every gradient, the pose adjustment's), one
  eval chunk's normals card vs CPU, and a 3-step profile.

Since phases 61-63 came, phases 36-37, 43, 45 and 50-51 run 600 steps
(1000 before), 42 and 44 (nerfacto distorted and masked) 300, 55
(nerfacto-big) 1000 of its gate's 3000, 57 300 (1000 before), 58-60 300
(500 before) and 62-63 300 (500 before), to keep the run inside its
budget.

Times the kernels, their twins and their library calls, the nerfacto frame
and training rays/s, the splatfacto step, refine and eval frame, and the
neus-facto step and eval frame; computes each kernel's bound (the least
time the card could take for the same work: bytes at 3.35 TB/s or float32
operations at 67 TFLOP/s, whichever is longer). A kernel's profiler time
(``device_ms``) is each kernel's mean duration per record times its
records per call, which holds when the profiler drops records; phases
28-31 add CUDA events around 50 calls back to back.

Phases print one line each. Any failure raises, so the exit code is nonzero
and the final line is missing. On success the last two lines are the
per-kernel JSON record and ``{"ok": true, "device": {...}}``. Needs a CUDA
device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

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


_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of the phase's report, with the seconds since the script began."""
    print(f"[{phase}] (+{time.perf_counter() - _START:.0f} s) {msg}", flush=True)


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


def _kernel_records(fn, calls: int):
    """{kernel name: [durations in us]} of the device activities under
    torch.profiler over ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            out.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    return out


def device_ms(fn, runs: int = 10) -> float:
    """Device time of one call of ``fn`` under torch.profiler: each kernel's
    mean duration per record over ``runs`` calls (after one warm-up), times
    the records of that kernel one call launches (the most of: a profiled
    single call's count, and the ``runs`` calls' count per call rounded
    up). Late in a long process the profiler drops records (3-9 of 10 seen),
    so dividing the summed durations by the calls made would read low; the
    mean per record holds. Unlike CUDA events around a single call it
    leaves out the host's time to launch it. NaN when three profiles in a
    row see no device activity."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # late in the process one profile can lose every record
        one, many = _kernel_records(fn, 1), _kernel_records(fn, runs)
        if many:
            break
    else:
        return float("nan")
    per_call = {k: max(len(one.get(k, ())), math.ceil(len(v) / runs)) for k, v in many.items()}
    return sum(statistics.fmean(many[k]) * c for k, c in per_call.items()) / 1e3


def kernel_records_ms(fn, key: str, runs: int = 10, tries: int = 3):
    """(mean device ms of one kernel record whose name holds ``key``, the
    records seen) under torch.profiler over ``runs`` calls of ``fn`` (after
    one warm-up): unlike ``device_ms`` it holds if the profiler drops
    records, as long as ``fn`` launches that kernel once. A profile that
    saw no such record is taken again, up to ``tries`` in all (late in the
    process one profile can lose every record of a kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name]
        if spans:
            break
    return (sum(spans) / 1e3 / len(spans) if spans else float("nan")), len(spans)


def batch_ms(fn, calls: int = 50) -> float:
    """CUDA events around ``calls`` back-to-back calls, per call: the
    device's time where a call's kernels take longer than the host's issue
    of it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def card_clocks() -> str:
    """The SM clock, its maximum, the power draw and the temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()


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
    """Every design of K1 or K3 timed in turns (``paired_ms``), by the
    profiler's device time and by CUDA events around 50 calls back to back:
    ({design: (mean, [medians])}, {design: device ms}, {design: ms})."""
    from nerfstudio_torch.ops import hash_grid as hg

    fns = {d: timing[d] for d in hg.DESIGNS}
    with torch.no_grad():
        return (paired_ms(fns), {d: device_ms(fn) for d, fn in fns.items()},
                {d: batch_ms(fn) for d, fn in fns.items()})


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
FLT_MIN = 2.0**-126  # the smallest normal float32
SUBNORMAL_ULP = 2.0**-149  # the spacing of float32 subnormals


def table_grad_bound(pos, table, g, scales, kw):
    """Per-entry limit on |kernel - float64 twin| of the table gradient: a
    float32 sum of k terms in any order is off by at most (k-1) * u * sum|t|
    (u = 2^-24), plus the four roundings of each term w8*g*scale. sum|t| is the
    float64 twin on |g| (weights and scales are >= 0); k counts each entry's
    terms from the geometry. A float atomic add to global memory flushes a
    subnormal result to zero (as index_add_ on the card does), so each term
    and each partial sum may also lose up to FLT_MIN: (k + 4) * FLT_MIN more
    (a cotangent below 1e-37 shows it). Every design rounds each term as the
    first does; the lane groups' vector reductions only regroup the sum, so
    the bound holds for each unchanged."""
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
    return ((counts + 4.0) * (U32 * abs_sum.view(L, -1) + FLT_MIN)).view(L, S, lanes)


def position_grad_bound(g, table, num_levels, features, min_res, max_res):
    """Per-sample limit on |kernel - float64 twin| of the position gradient.
    Each level adds res * clip' * d_o, d_o a signed sum of 8 terms
    d_w8[c] * (two weights in [0, 1]), d_w8[c] a sum of F products with
    bf16 table values within +-T (T the level's largest |value|, bf16-
    rounded, at least 1: a trained table holds values of several units);
    every step rounds once, so a level is off by at most ~(F + 12) u times
    res * 8 * T * sum_f |g_lf|, and the levels' sum adds L roundings more.
    A result in the subnormal range rounds to an absolute 2^-150 instead
    of a relative u (a trained scene's cotangents reach 1e-41, where a
    sample's whole gradient is subnormal and the relative term alone would
    ask for more bits than subnormals hold): each of a level's ~(F + 12)
    roundings per corner adds up to SUBNORMAL_ULP before the scaling by res,
    8 corners a level, L more in the levels' sum."""
    from nerfstudio_torch.ops.hash_grid import compute_level_resolutions

    res = torch.tensor(compute_level_resolutions(num_levels, min_res, max_res), dtype=torch.float64,
                       device=g.device)
    peak = (table.detach().reshape(num_levels, -1).abs().amax(-1).double() * (1 + 2.0**-8)).clamp_min(1.0)
    per_level = g.abs().double().view(g.shape[0], num_levels, features).sum(-1) * res * 8.0 * peak
    subnormal = (float((res * 8.0 * (features + 12)).sum()) + num_levels) * SUBNORMAL_ULP
    return (features + 12 + num_levels) * U32 * per_level.sum(-1, keepdim=True) + subnormal


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
    pos_over = int((pos_err > position_grad_bound(g, table, num_levels, features, min_res, max_res)).sum())
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


def build_training(device, rays, method=None, options=None):
    """nerfacto at the method config's width and schedule
    (configs/method_configs.py:92-110: field_bwd_level_period=2,
    proposal_freeze_after=2500), or ``method``'s shipped model config and
    optimizers (nerfacto-huge), with the model config's ``options``
    replaced, random weights from SEED, bench.py's synthetic scene, its
    pipeline, a fresh per-group Adam and the occupancy hook. Returns
    (config, pipeline, train state, hook)."""
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam, nerfacto_optimizers
    from nerfstudio_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline

    cfg = NerfactoModelConfig(eval_num_rays_per_chunk=CHUNK, field_bwd_level_period=2, proposal_freeze_after=2500)
    optimizers = nerfacto_optimizers()
    if method is not None:
        from nerfstudio_torch.configs.method_configs import get_method

        config = get_method(method)
        cfg, optimizers = config.model, config.optimizers
    if options:
        cfg = dataclasses.replace(cfg, **options)
    model = cfg.setup(num_train_data=TRAIN_IMAGES, device=device).train()
    model.reset_parameters(torch.Generator(device=device).manual_seed(SEED))
    images = np.random.default_rng(SEED).integers(0, 255, (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW, 3)).astype(np.uint8)
    dm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=rays),
                                orbit_cameras(TRAIN_IMAGES, TRAIN_HW, device), torch.from_numpy(images), device)
    state = TrainState(PerGroupAdam(optimizers, model), aux=model.init_aux(model, cfg, device))
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


def occupancy_bounds(res, cells, probes):
    """Byte bounds (ms, "bytes") of the occupancy grid's two functions, which
    are stock torch ops with no kernel of their own: the update (the
    reference's EMA at ``cells`` jittered cells, the field's densities there
    handed in: read the cells, their jitter and new densities, read and
    write the res^3 densities once, write the binary grid) and the probe of
    ``probes`` positions (read 12 bytes, write a 4-byte weight each; the
    binary grid read once)."""
    update = bound(9 * res**3 + cells * (8 + 12 + 4), 0)
    probe = bound(res**3 + probes * (12 + 4), 0)
    return update, probe


def profile_steps(cfg, pipeline, state, hook, start, gen):
    """Device time by kernel over PROFILED_STEPS steady nerfacto steps."""
    return profile_device(
        lambda: train_steps(cfg, pipeline, state, hook, range(start, start + PROFILED_STEPS), gen))


# kernel records by name in the last profile_device run (a kernel launched
# once per step shows whether the profiler dropped any)
PROFILE_RECORDS = {}


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
    PROFILE_RECORDS.clear()
    for e in prof.events():
        if e.name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"):
            gemm_flops += getattr(e, "flops", 0) or 0
        # device activities only: kernels, memsets, copies; not the ranges
        # that annotations such as Optimizer.step project onto the device
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            PROFILE_RECORDS[e.name] = PROFILE_RECORDS.get(e.name, 0) + 1
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
    ("hash-grid kernels", ("block_encode", "block_stochastic", "block_exact", "block_bwd_bwd", "bwd_lanes",
                           "bwd_private")),
    ("gsplat kernels", ("project_fwd", "project_bwd", "view_reduce", "tile_keys", "tile_ranges", "tile_count",
                        "tile_scan", "tile_scatter", "tile_sort", "blend_fwd", "blend_bwd")),
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
    """A K7 kernel's profiler name: the flat forward (both designs), the
    first-design backward and the private pass (K7 only) by name, the lane
    pass by its kBlock = false template argument."""
    name = name.lower()
    return ("flat_encode" in name or "flat_lanes" in name or "bwd_private" in name
            or ("bwd_lanes" in name and "false>" in name))


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


def card_vs_cpu_step(devices=("cuda", "cpu"), method=None, options=None):
    """One training step of the full-width model (or ``method``'s, with
    ``options`` replaced in its config) on the card and on the CPU twins:
    same weights (the card's, with flat tables), same grid (a sphere of
    radius 0.3 occupied, EMA densities 40 exp(-25 r^2)), same draws."""
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.models.nerfacto import NerfactoModel
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws

    gen = torch.Generator().manual_seed(SEED + 1)
    runs = []
    pixels = torch.stack([torch.randint(0, n, (CHECK_RAYS,), generator=gen)
                          for n in (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW)], dim=-1)
    probes, *rounds = (torch.rand((CHECK_RAYS, 1), generator=gen) for _ in range(4))
    weights = None
    for device in devices:
        cfg, pipeline, state, _ = build_training(device, CHECK_RAYS, method, options)
        if weights is None:
            flatten_tables(pipeline.model, torch.Generator().manual_seed(SEED + 2))
            weights = {k: v.detach().cpu().clone() for k, v in pipeline.model.state_dict().items()}
        pipeline.model.load_state_dict(weights)
        grid = state.aux
        if grid is not None:
            c = (torch.arange(grid.resolution, device=device, dtype=torch.float32) + 0.5) / grid.resolution - 0.5
            r2 = (c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2).reshape(-1)
            grid.binary = r2 <= 0.3**2
            grid.densities = 40.0 * torch.exp(-25.0 * r2)
        n_rounds = pipeline.model.num_proposal_rounds() + 1
        dev_draws = StepDraws(pixels.to(device), SamplerUniforms(
            probes.to(device), tuple(u.to(device) for u in rounds[:n_rounds])))
        kwargs = NerfactoModel.step_kwargs(300, cfg)  # live proposals, full field backward
        metrics = pipeline.train_step(state, draws=dev_draws, **kwargs)
        grads = {n: p.grad.detach().cpu().double() for n, p in pipeline.model.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, pipeline.model))
        del pipeline, state
    (m_card, g_card, model), (m_cpu, g_cpu, _) = runs
    return (m_card, m_cpu) + step_rel(m_card, g_card, m_cpu, g_cpu, model)


def step_rel(m_card, g_card, m_cpu, g_cpu, model):
    """(the loss's relative gap, the non-table gradients' largest gap over
    each one's peak, the tables' largest gap per level and feature over
    the peak) between a card step and a CPU step."""
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    grad_rel, table_rel = 0.0, 0.0
    for n, ref in g_cpu.items():
        got = g_card[n]
        if n.endswith("hash_table"):
            F = model.get_submodule(n.rsplit(".", 1)[0]).features_per_level
            sums = lambda x: x.reshape(x.shape[0], -1, F).sum(dim=1)  # noqa: E731
            table_rel = max(table_rel, float((sums(got) - sums(ref)).abs().max() / sums(ref).abs().max()))
        elif ref.abs().max() > 0:
            grad_rel = max(grad_rel, float((got - ref).abs().max() / ref.abs().max()))
    return loss_rel, grad_rel, table_rel


# --------------------------------------------------------------------------
# the splatfacto slice: training step and eval render


SPLAT_HW = 512  # tools/bench_models.py:105-170
SPLAT_SLOTS, SPLAT_RANDOM, SPLAT_SCALE = 100_000, 50_000, 1.5
SPLAT_CAMERAS = 8
SPLAT_START, SPLAT_WARMUP, SPLAT_TIMED = 6000, 5, 30
SPLAT_CHECK_HW, SPLAT_CHECK_GAUSS = 128, 4096
SPLAT_KERNELS = ("project_gaussians", "project_gaussians_bwd", "tile_bin", "tile_bin_bucketed", "tile_bin_sorted",
                 "blend_saturating", "blend_saturating_per_pixel", "blend_saturating_bwd")
# launches of each per splat step: one of every kernel in its default
# design, none of K6 forward's per-pixel design nor of K5's sorted one (a
# 512^2 frame is far below the bucketed design's tile limit)
SPLAT_STEP_LAUNCHES = {**dict.fromkeys(SPLAT_KERNELS, 1), "blend_saturating_per_pixel": 0, "tile_bin_sorted": 0}
# the gsplat kernels by profiler name (first match), one row each in the
# splat profiles: every kernel K4, K5 and K6 launch
GSPLAT_ROWS = (("K4 fwd", "project_fwd"), ("K4 bwd", "project_bwd"), ("K4 bwd viewmat sum", "view_reduce"),
               ("K5 tile_count", "tile_count"),
               ("K5 tile_scan", "tile_scan"), ("K5 tile_scatter", "tile_scatter"), ("K5 tile_sort", "tile_sort"),
               ("K5 sorted design", "tile_keys"), ("K5 sorted design", "tile_ranges"), ("K6 fwd", "blend_fwd"),
               ("K6 bwd", "blend_bwd"))

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


def build_splat(device, hw=SPLAT_HW, slots=SPLAT_SLOTS, n_random=SPLAT_RANDOM, params=None, **options):
    """splatfacto at the shipped config (sh_degree 3, saturating blend,
    big_frac 16, random background, DefaultStrategy; ``options`` override
    config fields) on tools/bench_models.py's setup: ``max_gaussians``
    slots, ``n_random`` random-init gaussians at random_scale 1.5 and
    scene_scale 1.5, no downscales, 8 orbit cameras at radius 2.5 and height
    1.2 over random images from SEED. ``params`` (CPU tensors) replace the
    init's."""
    from nerfstudio_torch.data.datamanagers import FullImageDatamanager
    from nerfstudio_torch.models.splatfacto import SplatfactoModel, SplatfactoModelConfig
    from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline

    cfg = SplatfactoModelConfig(max_gaussians=slots, num_random=n_random, random_init=True, random_scale=SPLAT_SCALE,
                                num_downscales=0, **options)
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


def k4_fwd_errors(name, m, s, q, cam):
    """K4's forward against the twin at one call's inputs: (outputs, twin
    outputs, max |kernel - twin| / peak per output over the gaussians in
    front of the camera, radii/valid flips, flips away from an integer
    ceil, max abs err)."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    with torch.no_grad():
        out = pj._project_kernel(m, s, q, cam)
        ref = pj._project_twin(m, s, q, *cam)
    torch.cuda.synchronize()
    front = ref[1] > 1e-3  # behind the camera z is clamped to 1e-6: see the projection parity test
    pairs = dict(zip(("means2d", "depths", "conics", "compensations"), zip(out[:3] + out[5:], ref[:3] + ref[5:])))
    errs, max_abs = {}, 0.0
    for k, (a, b) in pairs.items():
        if not torch.isfinite(a[front]).all():
            raise AssertionError(f"{name}: non-finite {k}")
        errs[k] = float((a[front] - b[front]).abs().max() / b[front].abs().max())
        max_abs = max(max_abs, float((a[front] - b[front]).abs().max()))
    flips = (out[3] != ref[3]) | (out[4] != ref[4])
    bad_flips = int((flips & ~near_integer_radius(ref[2])).sum())
    return out, ref, errs, int(flips.sum()), bad_flips, max_abs


def k4_bwd_errors(m, s, q, cam, cots):
    """K4's backward at one call's inputs against a float64 run of the twin:
    ({array: (kernel's, float32 twin's error / peak)}, the arrays over the
    limit, max |kernel - float32 twin|)."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    got = pj._project_bwd_kernel(m, s, q, cam, *cots)
    twin = pj._project_twin_bwd(m, s, q, cam, *cots)
    ref64 = pj._project_twin_bwd(m.double(), s.double(), q.double(), cam, *(c.double() for c in cots))
    torch.cuda.synchronize()
    over, errs, max_abs = [], {}, 0.0
    for k, a, b, r in zip(("means", "scales", "quats"), got, twin, ref64):
        e_k, e_t = float((a.double() - r).abs().max()), float((b.double() - r).abs().max())
        peak = float(r.abs().max())
        errs[k] = (e_k / peak, e_t / peak)
        max_abs = max(max_abs, float((a - b).abs().max()))
        if e_k > 2 * e_t + 1e-6 * peak or not torch.isfinite(a).all():
            over.append(k)
    return errs, over, max_abs


def k4_line(label, errs, flips, bad_flips, bwd_errs, bwd_over) -> str:
    return (f"{label}: forward max |kernel - twin| / peak " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f", radii/valid flips {flips} ({bad_flips} away from an integer ceil); backward max |x - float64 "
            "twin| / peak (kernel, float32 twin) " + ", ".join(f"{k} {a:.3g}/{b:.3g}" for k, (a, b) in
                                                            bwd_errs.items()) + f", over the limit: {bwd_over}")


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
        out, ref, errs, flips, bad_flips, fwd_abs = k4_fwd_errors(name, m, s, q, cam)
        valid = ref[4] & x["alive"]
        cots = [torch.randn(t.shape, generator=gen, device=m.device) * valid.view(-1, *([1] * (t.ndim - 1)))
                for t in ref[:3] + ref[5:]]
        bwd_errs, bwd_over, bwd_abs = k4_bwd_errors(m, s, q, cam, cots)
        max_abs = max(max_abs, fwd_abs, bwd_abs)
        failed = failed or max(errs.values()) > K4_REL or bad_flips or bool(bwd_over)
        lines.append(k4_line("antialiased" if antialiased else "classic", errs, flips, bad_flips, bwd_errs, bwd_over))
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
    bounds = (bound(nbytes(m, s, q, *outs), 250 * n), k4_bwd_bounds(m, s, q, cots, cam[-1])[0])
    timing = dict(
        fwd=lambda: pj._project_kernel(m, s, q, cam), fwd_twin=lambda: pj._project_twin(m, s, q, *cam),
        bwd=lambda: pj._project_bwd_kernel(m, s, q, cam, *cots),
        bwd_twin=lambda: pj._project_twin_bwd(m, s, q, cam, *cots),
    )
    return max_abs, timing, (out, valid), bounds


def k5_args(x, projected):
    """K5's arguments at the main path's shapes (tile_bin's, shipped binning)."""
    (m2, z, con, radii, *_), valid = projected
    tiles_x, tiles_y = (x["width"] + 15) // 16, (x["height"] + 15) // 16
    return (m2, radii, z, valid, tiles_x, tiles_y, 16, 16, 64)


def overflow_args(args):
    """``args`` with one tile made longer than one block of the bucketed
    sort orders at once (its merge path): the first TILE_SORT_KEYS + 4000
    gaussians moved into tile (10, 10) at radius 2, made valid, their depths
    kept."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    m2, radii, z, valid, *rest = args
    k = rz.TILE_SORT_KEYS + 4000
    gen = torch.Generator(device=m2.device).manual_seed(SEED + 5)
    m2, radii, valid = m2.clone(), radii.clone(), valid.clone()
    m2[:k] = 162.0 + 12.0 * torch.rand((k, 2), generator=gen, device=m2.device)
    radii[:k] = 2.0
    valid[:k] = True
    return (m2, radii, z, valid, *rest)


def check_k5(name, args, what):
    """Every design of K5 against its twin on ``args``: starts, counts and
    the live entries (the first counts.sum()) of packed and ids exactly
    equal; the first design also its sentinel tail, as before. Logs the
    live pairs, the sentinels the first design writes, and the pairs per
    tile. Returns a record: sizes, bound, the bins, timing fns (each design,
    the twin, and torch.sort of the live keys shuffled and of all of the
    first design's keys shuffled)."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    ref = rz._tile_bin_twin(*args)
    total = int(ref.counts.sum())
    got, same = {}, {}
    for d in rz.TILE_BIN_DESIGNS:
        got[d] = rz._tile_bin_kernel(*args, _design=d)
        torch.cuda.synchronize()
        upto = None if d == "sorted" else total
        same[d] = {k: bool(torch.equal(getattr(got[d], k)[:upto], getattr(ref, k)[:upto]))
                   for k in ("packed", "ids")}
        same[d].update({k: bool(torch.equal(getattr(got[d], k), getattr(ref, k))) for k in ("starts", "counts")})
    counts = ref.counts.double()
    slots = ref.packed.numel()
    m2, radii, z, valid, tiles_x, tiles_y = args[:6]
    rec = dict(what=what, tiles=tiles_x * tiles_y, slots=slots, live=total, sentinels=slots - total,
               per_tile_mean=float(counts.mean()), per_tile_max=int(counts.max()),
               longer_than_shared=int((ref.counts > rz.TILE_SORT_KEYS).sum()))
    log(name, f"{what}: {int(valid.sum())} valid gaussians, {tiles_x}x{tiles_y} tiles, {slots} window slots: "
        f"{total} live pairs, {slots - total} sentinels in the first design, per tile mean "
        f"{rec['per_tile_mean']:.0f} max {rec['per_tile_max']} ({rec['longer_than_shared']} tiles over the "
        f"{rz.TILE_SORT_KEYS} keys one block sorts at once); equal to the twin: {same}")
    if not all(all(v.values()) for v in same.values()):
        raise AssertionError(f"{name}: a design disagrees with its twin ({what})")
    n_big = max(m2.shape[0] // args[7], 1) if args[7] else 0
    # the inputs once (the big window's indices too), the tiles' ranges and
    # the live entries of packed and ids once; no flops to speak of
    rec["bound"] = bound(nbytes(m2, radii, z, valid) + 8 * n_big + 8 * tiles_x * tiles_y + 12 * total, 0)
    dev = m2.device
    live = ref.packed[:total].to(dev)
    live = live[torch.randperm(total, device=dev)]
    every = got["sorted"].packed[torch.randperm(slots, device=dev)]
    rec["timing"] = {d: (lambda d=d: rz._tile_bin_kernel(*args, _design=d)) for d in rz.TILE_BIN_DESIGNS}
    rec["timing"].update({"torch.sort, live keys": lambda: torch.sort(live),
                          "torch.sort, all keys": lambda: torch.sort(every)})
    rec["twin"] = lambda: rz._tile_bin_twin(*args)
    rec["bins"] = got[rz.TILE_BIN_DESIGNS[0]]
    return rec


def time_k5(rec):
    """Every design and both torch.sort yardsticks in turns (``paired_ms``)
    and by the profiler's device time, into ``rec``."""
    with torch.no_grad():
        ev = paired_ms(rec["timing"])
        dev = {k: device_ms(fn) for k, fn in rec["timing"].items()}
    rec["times"] = {k: dict(ms=ev[k][0], ms_runs=ev[k][1], device_ms=dev[k]) for k in rec["timing"]}
    return rec


ABOVE_LIMIT_HW = (4096, 4352)  # 256 x 272 = 69,632 tiles, above the bucketed design's 58,112


def check_k5_above_limit(name, args, width, height):
    """K5 at a frame above the bucketed design's tile limit: ``args``'s
    gaussians (the check inputs, at ``width`` x ``height``) spread over a
    4096x4352 frame (means and radii scaled), through the default routing.
    The sorted design must take it (one ``tile_bin_sorted`` launch, no
    bucketed one) and equal the twin exactly on starts, counts and the live
    entries. Returns a record for the kernels line."""
    from nerfstudio_torch.ops.gsplat import _cuda as sc
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    m2, radii, z, valid, _, _, *binning = args
    W, H = ABOVE_LIMIT_HW
    scale = torch.tensor([W / width, H / height], device=m2.device)
    big = (m2 * scale, (radii * (H / height)).to(radii.dtype), z, valid, (W + 15) // 16, (H + 15) // 16, *binning)
    tiles = big[4] * big[5]
    sc.reset_launch_counts()
    got = rz._tile_bin_kernel(*big)
    torch.cuda.synchronize()
    routed = {k: sc.launch_counts[k] for k in ("tile_bin", "tile_bin_bucketed", "tile_bin_sorted")}
    ref = rz._tile_bin_twin(*big)
    total = int(ref.counts.sum())
    same = {k: bool(torch.equal(getattr(got, k), getattr(ref, k))) for k in ("starts", "counts")}
    same.update({k: bool(torch.equal(getattr(got, k)[:total], getattr(ref, k)[:total])) for k in ("packed", "ids")})
    ms = median_ms(lambda: rz._tile_bin_kernel(*big), runs=5, warmup=1)
    log(name, f"a {W}x{H} frame, {tiles} tiles (the bucketed design takes {rz.SHARED_BYTES_PER_BLOCK // 4}): "
        f"design {rz.tile_bin_design(tiles)}, launches {routed}; {total} live pairs, max "
        f"{int(ref.counts.max())} per tile; equal to the twin: {same}; {ms:.3f} ms")
    if routed != {"tile_bin": 1, "tile_bin_bucketed": 0, "tile_bin_sorted": 1} or not all(same.values()):
        raise AssertionError(f"{name}: the frame above the tile limit was not binned exactly by the sorted design")
    return dict(width=W, height=H, tiles=tiles, design=rz.tile_bin_design(tiles), launches=routed, live=total,
                equal_to_twin=same, ms=ms)


def k5_line(rec) -> str:
    return (f"{rec['what']} ({rec['live']} live of {rec['slots']}, max {rec['per_tile_max']} per tile, bound "
            f"{rec['bound'][0]:.4f} ms): " + ", ".join(
                f"{k} {v['ms']:.4f} {[round(m, 4) for m in v['ms_runs']]} / {v['device_ms']:.4f}"
                for k, v in rec["times"].items()))


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


def cull_share(m2, con, op, bins, T, last):
    """The share of (warp, staged entry) pairs that the culled design skips,
    from the same predicate in torch (``rasterize._warp_culled``): a warp
    tests a batch of 256 entries where it is not yet done at the batch's
    start (one of its pixels has T >= 1e-4 at the end, or blends past the
    batch's start); a block stages no batch after all its warps are done.
    Returns (skipped, tested)."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    ext = rz._cull_extents(m2, con, op)
    t_tiles = rz._image_to_tiles(T[..., None], bins)[..., 0]
    l_tiles = rz._image_to_tiles(last[..., None], bins)[..., 0]
    counts = bins.counts.cpu().numpy()
    live = int(counts.sum())
    skipped = tested = 0
    for t0, t1, k in rz._tile_batches(counts):
        dev = m2.device
        tiles = torch.arange(t0, t1, device=dev)
        off = torch.arange(k, device=dev)
        in_seg = off[None, :] < bins.counts[t0:t1, None]
        entry = torch.clamp_max(bins.starts[t0:t1, None].long() + off[None, :], max(live - 1, 0))
        culled = rz._warp_culled(m2, ext, bins.ids[entry].long(), tiles, bins.tiles_x)  # (C, 8, k)
        warp_T = t_tiles[t0:t1][:, rz.warp_pixels(dev)]  # (C, 8, 32)
        warp_last = l_tiles[t0:t1][:, rz.warp_pixels(dev)]
        batch_start = (off // 256) * 256
        active = (warp_T >= 1e-4).any(-1)[..., None] | (warp_last.amax(-1)[..., None] > batch_start)
        pairs = active & in_seg[:, None, :]
        tested += int(pairs.sum())
        skipped += int((pairs & culled).sum())
    return skipped, tested


def check_k6_designs(name, label, m2, con, ch, op, bins, w, h):
    """Every design of K6's forward on one set of inputs: out, T and last
    bit-equal to the per-pixel design's (torch.equal), and each within
    K6_FWD_REL of each channel's peak of the twin. Returns a record: sizes,
    entries walked, bound (``check_k6``'s formula), cull share, errors, and
    each design's timing fn."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    designs = rz.BLEND_FWD_DESIGNS
    with torch.no_grad():
        ref = rz._blend_twin(m2, con, ch, op, bins, w, h)
        got = {d: rz._blend_kernel(m2, con, ch, op, bins, w, h, _design=d) for d in designs}
    torch.cuda.synchronize()
    live = int(bins.counts.sum())
    ch_peak = ch[bins.ids[:live].long()].abs().amax(dim=0).clamp_min(1.0)
    equal = {d: all(torch.equal(a, b) for a, b in zip(got[d], got["per_pixel"])) for d in designs}
    rel = {d: float(((got[d][0] - ref).abs().amax(dim=(0, 1)) / ch_peak).max()) for d in designs}
    err = {d: float((got[d][0] - ref).abs().max()) for d in designs}
    out, T, last = got[rz.BLEND_FWD_DESIGNS[0]]
    walked = float(last.double().sum())
    skipped, tested = cull_share(m2, con, op, bins, T, last)
    rec = dict(inputs=label, entries=live, per_tile_max=int(bins.counts.max()), walked=walked,
               bound=bound(nbytes(m2, con, ch, op, bins.ids, bins.starts, bins.counts, out, T, last), 15 * walked),
               cull_share=skipped / max(tested, 1), pairs_tested=tested, bit_equal=equal, rel=rel, max_abs_err=err,
               saturated=float((T < 1e-4).float().mean()))
    log(name, f"{label} ({w}x{h}, {live} entries in tiles, max {rec['per_tile_max']} a tile, {walked / (w * h):.0f} "
        f"walked per pixel, bound {rec['bound'][0]:.4f} ms by {rec['bound'][1]}): bit-equal to per_pixel {equal}; "
        "max |design - twin| / channel peak " + ", ".join(f"{d} {v:.3g}" for d, v in rel.items())
        + f" (limit {K6_FWD_REL}); cull share {rec['cull_share']:.3f} of {tested} (warp, staged entry) pairs")
    if not all(equal.values()) or max(rel.values()) > K6_FWD_REL or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: a design of K6's forward is not bit-equal to the per-pixel one or "
                             f"disagrees with the twin ({label})")
    rec["timing"] = {d: (lambda d=d: rz._blend_kernel(m2, con, ch, op, bins, w, h, _design=d)) for d in designs}
    return rec


def non_finite_inputs(m2, con, ch, op, bins, w, h):
    """K6's inputs with a NaN or infinite conic value or opacity on every
    7th gaussian of the tiles' lists: the reference's mask skips an entry
    whose sigma or alpha is NaN (both designs must too)."""
    con, op = con.clone(), op.clone()
    ids = bins.ids[: int(bins.counts.sum())].long().unique()[::7]
    bad = torch.tensor([float("nan"), float("inf")], device=con.device)
    k = torch.arange(ids.shape[0], device=con.device)
    on_conic = k % 4 < 3
    con[ids[on_conic], (k % 3)[on_conic]] = bad[k[on_conic] % 2]
    op[ids[~on_conic]] = bad[k[~on_conic] % 2]
    return m2, con, ch, op, bins, w, h


def time_k6(rec):
    """Every design of K6's forward in turns: CUDA events around one call
    (``paired_ms``) and around 50 back to back (``batch_ms``), the
    profiler's device time per call (``device_ms``) and per kernel record
    (``kernel_records_ms``, with the records seen of 10), into ``rec``;
    with the card's clocks before and after."""
    rec["clocks"] = [card_clocks()]
    with torch.no_grad():
        ev = paired_ms(rec["timing"])
        batch = {k: batch_ms(fn) for k, fn in rec["timing"].items()}
        dev = {k: device_ms(fn) for k, fn in rec["timing"].items()}
        per_record = {k: kernel_records_ms(fn, "blend_fwd") for k, fn in rec["timing"].items()}
    rec["clocks"].append(card_clocks())
    rec["times"] = {k: dict(ms=ev[k][0], ms_runs=ev[k][1], batch_ms=batch[k], device_ms=dev[k],
                            record_ms=per_record[k][0], records=per_record[k][1]) for k in rec.pop("timing")}
    return rec


def k6_line(rec) -> str:
    return (f"{rec['inputs']} (bound {rec['bound'][0]:.4f} ms, cull share {rec['cull_share']:.3f}; clocks, power, "
            f"temperature before / after {rec['clocks']}): " + ", ".join(
                f"{k} {v['ms']:.4f} {[round(m, 4) for m in v['ms_runs']]} / batched {v['batch_ms']:.4f} / device "
                f"{v['device_ms']:.4f} / per record {v['record_ms']:.4f} ({v['records']} records)"
                for k, v in rec["times"].items()))


def gsplat_rows(rows) -> str:
    """The profile's gsplat kernels, one row per kernel (``GSPLAT_ROWS``),
    and their sum, which is the gsplat class's total."""
    got, records = {}, {}
    for name, t in rows:
        if kernel_class(name) != "gsplat kernels":
            continue
        label = next((lab for lab, key in GSPLAT_ROWS if key in name.lower()), name[:40])
        got[label] = got.get(label, 0.0) + t
        records[label] = records.get(label, 0) + PROFILE_RECORDS.get(name, 0)
    return ", ".join(f"{k} {v:.4f} ({records[k]} records)" for k, v in got.items()) + \
        f"; sum {sum(got.values()):.4f}"


def capture_kernel_calls(targets, run):
    """The arguments of every call of each launcher in ``targets`` ({label:
    (module, function name)}) during ``run()``, as the path's own calls hand
    them over (tensors detached and cloned): {label: [(args, kwargs)]}."""
    seen = {k: [] for k in targets}
    launch = {k: getattr(mod, f) for k, (mod, f) in targets.items()}

    def capture(k):
        def call(*args, **kw):
            seen[k].append(([a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args], dict(kw)))
            return launch[k](*args, **kw)
        return call

    for k, (mod, f) in targets.items():
        setattr(mod, f, capture(k))
    try:
        run()
    finally:
        for k, (mod, f) in targets.items():
            setattr(mod, f, launch[k])
    return seen


def capture_splat_calls(pipeline, state, gen):
    """The arguments of K5 (``_tile_bin_kernel``) and of K6's backward in one
    steady-state splat step, as the step's own calls hand them over
    (tensors cloned): {"tile_bin": args, "blend_bwd": (means2d, conics, ch,
    opac, the bins, T, last, the cotangent g_ch)}."""
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    seen = capture_kernel_calls({"tile_bin": (rz, "_tile_bin_kernel"), "blend_bwd": (rz, "_blend_bwd_kernel")},
                                lambda: splat_steps(pipeline, state, 1, gen))
    if any(len(v) != 1 for v in seen.values()):
        raise AssertionError(f"one splat step called K5 and K6's backward {[len(v) for v in seen.values()]} times")
    return {k: v[0][0] for k, v in seen.items()}


def splat_steps(pipeline, state, n, gen):
    """``n`` steps through ``SplatPipeline.train``'s schedule, each checked
    for exactly one launch of each of the five kernels in its default
    design (``SPLAT_STEP_LAUNCHES``). Returns the last step's metrics."""
    from nerfstudio_torch.ops.gsplat import _cuda as sc

    metrics = None
    for _ in range(n):
        before = dict(sc.launch_counts)
        state, metrics = pipeline.train(state, state.step + 1, gen)
        got = {k: sc.launch_counts[k] - before[k] for k in SPLAT_KERNELS}
        if got != SPLAT_STEP_LAUNCHES:
            raise AssertionError(f"step {state.step - 1}: launches {got}, expected {SPLAT_STEP_LAUNCHES}")
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
# launches in the first designs, which no path takes (K7's forward, the
# backwards of K1 and K7, K3b and K1bb)
PER_THREAD = ("hash_encode_flat_per_thread", "hash_encode_bwd_per_thread", "hash_encode_normals_per_thread")

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
    roundings per term (w = (wx*wy)*wz, then w*g), plus FLT_MIN per term and
    partial sum for the atomics' flush of subnormals (table_grad_bound);
    sum|t| is the float64 twin on |g|, the term count each lane's from the
    corners of nonzero weight. As for table_grad_bound, every design rounds
    each term the same way and only regroups the sum: the lane groups'
    vector reductions, and the privatised levels' warp scans, shared copies
    and slab sums."""
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
    return ((counts + 4.0) * (U32 * abs_sum.view(L, -1) + FLT_MIN)).view(L, S, lanes)


def check_flat(name, pos, table, kw, what):
    """Every design of K7's forward (``hash_grid.DESIGNS``) against its twin on
    ``pos``, ``table``: within K7_MAX_ABS (bit-equal expected). Returns
    ({design: max abs err}, timing {design: fn, "kernel": the default
    design, "twin": the twin}, bound)."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    errs, parts, bad = {}, [], []
    with torch.no_grad():
        ref = hg._flat_twin(pos, table, **kw)
        for v in hg.DESIGNS:
            out = hg._flat_kernel(pos, table, _design=v, **kw)
            torch.cuda.synchronize()
            errs[v] = float((out - ref).abs().max())
            parts.append(f"{v}: max |kernel - twin| = {errs[v]:.3g}, bit-equal {bool(torch.equal(out, ref))}")
            if not torch.isfinite(out).all() or errs[v] > K7_MAX_ABS:
                bad.append(v)
    log(name, f"{what}: N={pos.shape[0]} L={L} F={F} T={kw['hash_table_size']} res {kw['min_res']}-{kw['max_res']} "
        f"(limit {K7_MAX_ABS}); " + "; ".join(parts))
    if bad:
        raise AssertionError(f"{name}: the {bad} kernels disagree with their twin")
    timing = {v: (lambda v=v: hg._flat_kernel(pos, table, _design=v, **kw)) for v in hg.DESIGNS}
    timing["kernel"] = lambda: hg._flat_kernel(pos, table, **kw)
    timing["twin"] = lambda: hg._flat_twin(pos, table, **kw)
    return errs, timing, bound(nbytes(pos, table, ref), hash_fwd_ops(pos.shape[0], L, F))


def time_flat(timing):
    """Every K7 forward design in turns (``paired_ms``) and by the profiler's
    device time: {design: (events mean, [medians], device ms)}."""
    from nerfstudio_torch.ops import hash_grid as hg

    fns = {v: timing[v] for v in hg.DESIGNS}
    with torch.no_grad():
        ev = paired_ms(fns)
        return {v: (ev[v][0], ev[v][1], device_ms(fn)) for v, fn in fns.items()}


def capture_flat_inputs(model, cams):
    """The positions and tables that the middle chunk of a FRAME_HW^2
    neus-facto frame hands to K7 (both proposal nets' calls), as
    ``render_camera``'s own calls of ``hash_grid._flat_kernel`` pass them
    (cloned): [(pos, table, geometry kwargs)] * 2."""
    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.ops import hash_grid as hg

    chunks = math.ceil(FRAME_HW * FRAME_HW / NEUS_RAYS)
    pick, seen, launch = chunks // 2, [], hg._flat_kernel

    def capture(pos, table, **kw):
        seen.append((pos.clone(), table.detach().clone(), kw) if len(seen) // 2 == pick else None)
        return launch(pos, table, **kw)

    hg._flat_kernel = capture
    try:
        render_camera(model, None, cams, 0, NEUS_RAYS)
    finally:
        hg._flat_kernel = launch
    if len(seen) != 2 * chunks:
        raise AssertionError(f"one neus-facto frame called K7 {len(seen)} times, not {2 * chunks}")
    return [c for c in seen if c is not None]


def neus_frame_in(model, cams, design):
    """One FRAME_HW^2 neus-facto frame through ``render_camera`` with K7's
    forward launched in ``design`` (one of ``hash_grid.DESIGNS``)."""
    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.ops import hash_grid as hg

    launch = hg._flat_kernel
    hg._flat_kernel = lambda pos, table, **kw: launch(pos, table, _design=design, **kw)
    try:
        return render_camera(model, None, cams, 1, NEUS_RAYS)
    finally:
        hg._flat_kernel = launch


def frames_in_turns(model, cams):
    """One neus-facto frame per K7 forward design, in order and then in
    reverse (CUDA events): {design: (mean, [two frames' ms])}."""
    from nerfstudio_torch.ops import hash_grid as hg

    got = {v: [] for v in hg.DESIGNS}
    for v in list(hg.DESIGNS) + list(reversed(hg.DESIGNS)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        neus_frame_in(model, cams, v)
        end.record()
        end.synchronize()
        got[v].append(start.elapsed_time(end))
    return {v: (statistics.fmean(ms), ms) for v, ms in got.items()}


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
    pos_over = int((pos_err > position_grad_bound(g, table, PROP_LEVELS, PROP_F, PROP_MIN_RES, PROP_MAX_RES)).sum())
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
    launcher) during ``run()``: [(args, kwargs)]."""
    from nerfstudio_torch.ops import hash_grid as hg

    return capture_kernel_calls({name: (hg, name)}, run)[name]


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


def bwd_designs_vs_twin(name, kind, pos, table, g, kw, scales=None, need_positions=True, need_table=True):
    """Every design of K1's (``kind`` "K1", with ``scales``) or K7's backward
    against the float64 twin on one set of inputs: the table gradient within
    its summation-order bound on every entry, the positions within theirs,
    K1's levels of scale 0 untouched. Raises on a miss. Returns ({design:
    errors}, the launcher by design, the last design's outputs, the
    scales)."""
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
    pos_bound = position_grad_bound(g, table, L, F, kw["min_res"], kw["max_res"]) if need_positions else None
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
    return designs, run, outs, scales


def check_bwd_designs(name, kind, pos, table, g, kw, scales=None, need_positions=True, need_table=True,
                      yardstick=True):
    """``bwd_designs_vs_twin``, then every design and (with ``yardstick``)
    the "scatter alone" yardstick timed in turns (CUDA events,
    ``paired_ms``) and by the profiler's device time. Returns a record: n,
    scales, needs, bound, {design: errors and times}, the yardstick's
    times."""
    from nerfstudio_torch.ops import hash_grid as hg

    needs = dict(need_positions=need_positions, need_table=need_table)
    designs, run, outs, scales = bwd_designs_vs_twin(name, kind, pos, table, g, kw, scales, **needs)
    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    n = pos.shape[0]
    fns = {d: (lambda d=d: run(d)) for d in hg.DESIGNS}
    yardstick = yardstick and need_table
    if yardstick:
        idx, vals = scatter_pairs(kind, pos, table, g, scales, kw)
        target = torch.zeros(table.numel(), device=table.device)
        fns["scatter alone"] = lambda: target.index_add_(0, idx, vals)
    times = paired_ms(fns)
    dev = {k: device_ms(fn) for k, fn in fns.items()}
    bat = {k: batch_ms(fn) for k, fn in fns.items()}
    for d in hg.DESIGNS:
        designs[d].update(ms=times[d][0], ms_runs=times[d][1], device_ms=dev[d], batch_ms=bat[d])
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
                scatter_alone=(dict(ms=times["scatter alone"][0], device_ms=dev["scatter alone"],
                                    batch_ms=bat["scatter alone"], pairs=int(idx.numel()))
                               if yardstick else None))


def bwd_design_line(label, rec) -> str:
    """One input set's times: events mean [two medians] / device ms / back to back."""
    parts = [f"{d} {r['ms']:.4f} {[round(m, 4) for m in r['ms_runs']]} / {r['device_ms']:.4f} / {r['batch_ms']:.4f}"
             for d, r in rec["designs"].items()]
    if rec["scatter_alone"]:
        sa = rec["scatter_alone"]
        parts.append(f"scatter alone ({sa['pairs']} pairs) {sa['ms']:.4f} / {sa['device_ms']:.4f} / {sa['batch_ms']:.4f}")
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
        "fused_gather": lambda *a: select_twin("fused_gather", a).view(gp.N_BLOCKS, gp.S, 128),
        "stage1": gp._row_gather_twin,
        "stage2": lambda *a: select_twin("stage2", a),
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
    want["gather_select_rows"] = want["fused_gather"] + want["stage2"]  # the default design
    want["gather_select_per_element"] = 0
    want["lane_gather_smem"] = sum(1 for k in ("run_case", "f4") for tab, _ in inputs[k].values()
                                   if gp._lane_plan(tab.shape[0], tab.element_size()))
    if launches != want:
        raise AssertionError(f"{name}: probe launches {launches}, expected {want} (one per variant, run_case's "
                             "and f4's through the shared-memory lane gather where _lane_plan gives lanes, "
                             "fused_gather's and stage2's in the rows design)")
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
            bat = {d: batch_ms(fn) for d, fn in fns.items()}
        records[(k, v)] = dict(
            lanes=plan, default=default, bound=bound(nbytes(tab, rows, ref), 0),
            library_ms=times["torch.gather"][0] if in_range else None,
            library_device_ms=dev["torch.gather"] if in_range else None,
            library_batch_ms=bat["torch.gather"] if in_range else None,
            designs=[dict(design=d, lanes=l, max_abs_err=errs[d], ms=times[d][0], ms_runs=times[d][1],
                          device_ms=dev[d], batch_ms=bat[d]) for d, l in designs.items()])
        lines.append(f"{k} {v} (plan {plan} lanes: {default}; events / device ms / back to back): "
                     + ", ".join(f"{d} {times[d][0]:.4f} / {dev[d]:.4f} / {bat[d]:.4f}" for d in fns)
                     + ", all equal to the twin")
        del ref
    log(name, "; ".join(lines))
    return records


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
SELECT_KERNELS = {"rows": "gather_select_rows_kernel", "per_element": "gather_select_kernel"}  # profiler names


def select_call(probe, args, design, features=None):
    """``fused_gather``'s or ``stage2``'s gather-select on ``args`` (table,
    rows, slots, w) in ``design`` (one of ``GATHER_SELECT_DESIGNS``): (n,
    128)."""
    from nerfstudio_torch.ops import gather_probes as gp

    return gp._gather_select(probe, *args, gp.F if features is None else features, probe == "stage2",
                             _design=design)


def select_twin(probe, args, features=None):
    """The plain twin of ``select_call`` on the card: (n, 128)."""
    from nerfstudio_torch.ops import gather_probes as gp

    table, *idx = args
    c = idx[0].shape[1] if probe == "stage2" else idx[0].shape[0]
    cm = (lambda x: x.permute(1, 0, 2).reshape(c, -1)) if probe == "stage2" else (lambda x: x.reshape(c, -1))
    return gp._gather_select_twin(table, *(cm(x) for x in idx), gp.F if features is None else features,
                                  probe == "stage2")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal float32 tensors (NaN payloads and signed zeros too)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def select_edge_inputs(gen):
    """[(label, probe, args, features, in range)] of phase 33: the edge
    inputs of the gather-select at smaller sizes, in both layouts (fused_gather's
    (corners, blocks, s), stage2's (blocks, corners, blk)) and table types.
    ``in range``: indices in the table and slots in the row, where the twin
    applies."""
    def table(rows, dtype):
        return torch.randn((rows, 128), generator=gen, device="cuda").to(dtype)

    def ints(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device="cuda", dtype=torch.int64).to(torch.int32)

    def layout(probe, c, nb, blk):
        return (nb, c, blk) if probe == "stage2" else (c, nb, blk)

    out = []
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for probe in ("fused_gather", "stage2"):
        for tname, dt in types.items():
            rows_t = 4096
            shape = layout(probe, 8, 4, 2048)
            tab = table(rows_t, dt)
            # rows and slots over the whole int32 range and around the edges
            r = ints(INT32_MIN, INT32_MAX + 1, shape)
            sl = ints(INT32_MIN, INT32_MAX + 1, shape)
            edges = torch.tensor([INT32_MIN, INT32_MIN + 1, -1, 0, 1, 31, 32, 127, 128, rows_t - 1, rows_t,
                                  rows_t + 1, INT32_MAX - 1, INT32_MAX], dtype=torch.int32, device="cuda")
            flat_r, flat_s = r.view(-1), sl.view(-1)
            flat_r[: edges.numel()] = edges
            flat_s[: edges.numel()] = edges.flip(0)
            flat_s[edges.numel(): 8192] = ints(-2, 34, (8192 - edges.numel(),))  # near the entries' range
            w = torch.rand(shape, generator=gen, device="cuda")
            out.append((f"{tname}, rows and slots over the int32 range", probe, (tab, r, sl, w), None, False))
            # NaN, +-inf and negative weights, indices in range
            r = ints(0, rows_t, shape)
            sl = ints(0, 128 // 4, shape)
            w = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
            special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, -1.5], device="cuda")
            pick = torch.randint(0, 40, shape, generator=gen, device="cuda")
            w = torch.where(pick < special.numel(), special[pick.clamp(max=special.numel() - 1)], w)
            out.append((f"{tname}, NaN, infinite and negative weights", probe, (tab, r, sl, w), None, True))
        for f in (1, 2, 8, 16, 128):
            for tname, dt in types.items():
                shape = layout(probe, 8, 2, 1024)
                args = (table(512, dt), ints(0, 512, shape), ints(0, 128 // f, shape),
                        torch.rand(shape, generator=gen, device="cuda"))
                out.append((f"{tname}, F={f}", probe, args, f, True))
    # a block that is not a multiple of 32 (stage2's layout, BLK = 1000), n
    # not a multiple of 32 in both layouts, and 3 corners at F = 4 (the
    # per-lane walk)
    for probe, shape, label in (("stage2", (7, 8, 1000), "BLK=1000"), ("stage2", (3, 8, 999), "BLK=999, n=2997"),
                                ("fused_gather", (8, 3, 1001), "n=3003"), ("stage2", (4, 3, 1024), "3 corners"),
                                ("fused_gather", (3, 4, 1024), "3 corners")):
        for tname, dt in types.items():
            args = (table(1024, dt), ints(0, 1024, shape), ints(0, 32, shape),
                    torch.rand(shape, generator=gen, device="cuda"))
            out.append((f"{tname}, {label}", probe, args, None, True))
    return out


def check_select_designs(name, inputs, gen):
    """The gather-select of fused_gather and stage2 in both designs of
    ``GATHER_SELECT_DESIGNS``: at the four probe variants of ``probe_inputs``
    (fused_gather and stage2, float32 and bfloat16 tables) each design
    ``torch.equal`` to the twin and bit-equal to the others; at the edge
    inputs of ``select_edge_inputs`` the designs bit-equal to each other (and
    to the twin where the indices lie in range, NaN matching NaN); then
    every design timed in turns at the four variants: 50 calls back to back
    (``batch_ms``), single calls between CUDA events, and the profiler's time
    per kernel record with the records seen. Returns {(probe, variant):
    record}."""
    from nerfstudio_torch.ops import gather_probes as gp

    designs = list(gp.GATHER_SELECT_DESIGNS)
    edges = select_edge_inputs(gen)
    with torch.no_grad():
        for label, probe, args, features, in_range in edges:
            outs = {d: select_call(probe, args, d, features) for d in designs}
            torch.cuda.synchronize()
            for d in designs[1:]:
                if not same_bits(outs[d], outs[designs[0]]):
                    bad = int((outs[d].view(torch.int32) != outs[designs[0]].view(torch.int32)).sum())
                    raise AssertionError(f"{name}: {probe} {label}: {d} differs from {designs[0]} in {bad} values")
            if in_range:
                ref = select_twin(probe, args, features)
                o = outs[designs[0]]
                if not bool(((o == ref) | (o.isnan() & ref.isnan())).all()):
                    raise AssertionError(f"{name}: {probe} {label}: the designs differ from the twin")
            del outs
    log(name, f"{len(edges)} edge inputs, every design bit-equal to the others: "
        + "; ".join(f"{probe} {label}" for label, probe, *_ in edges))

    records, lines = {}, []
    with torch.no_grad():
        for probe in ("fused_gather", "stage2"):
            for v, args in inputs[probe].items():
                ref = select_twin(probe, args)
                outs = {d: select_call(probe, args, d) for d in designs}
                torch.cuda.synchronize()
                for d, o in outs.items():
                    if not torch.equal(o, ref) or not same_bits(o, outs[designs[0]]):
                        raise AssertionError(f"{name}: {probe} {v} ({d}) differs from the twin or the default")
                n = ref.shape[0]
                bnd = bound(nbytes(*args, ref), 8 * n * 128 * 2)
                del outs, ref
                fns = {d: (lambda d=d: select_call(probe, args, d)) for d in designs}
                batch = {d: [] for d in designs}
                for d in designs + designs[::-1]:
                    batch[d].append(batch_ms(fns[d]))
                events = paired_ms(fns)
                rec_ms = {d: kernel_records_ms(fns[d], SELECT_KERNELS[d]) for d in designs}
                records[(probe, v)] = dict(
                    n=n, bound_ms=bnd[0], bound_by=bnd[1], clocks=card_clocks(),
                    designs=[dict(design=d, batch_ms=statistics.fmean(batch[d]), batch_ms_runs=batch[d],
                                  ms=events[d][0], ms_runs=events[d][1], device_ms=rec_ms[d][0],
                                  records=rec_ms[d][1]) for d in designs])
                lines.append(f"{probe} {v} (bound {bnd[0]:.4f} ms by {bnd[1]}; back to back / events / device "
                             "[records]): " + ", ".join(
                                 f"{d} {statistics.fmean(batch[d]):.4f} / {events[d][0]:.4f} / {rec_ms[d][0]:.4f} "
                                 f"[{rec_ms[d][1]}]" for d in designs))
    log(name, "every design torch.equal to the twin at the probe variants; on " + card_line() + ": "
        + "; ".join(lines) + f"; default: {gp.GATHER_SELECT_DESIGNS[0]}")
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
    launches (one per proposal net) and two backward, none of them in a
    per-thread design. Returns the last step's metrics."""
    from nerfstudio_torch.models.neus import NeuSFactoModel
    from nerfstudio_torch.ops import hash_grid as hg

    metrics = None
    for step in steps:
        before = dict(hg.launch_counts)
        state.step = step
        metrics = pipeline.train_step(state, gen, **NeuSFactoModel.step_kwargs(step, cfg))
        got = {k: hg.launch_counts[k] - before[k] for k in NEUS_KERNELS + PER_THREAD}
        if got != dict(dict.fromkeys(NEUS_KERNELS, 2), **dict.fromkeys(PER_THREAD, 0)):
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


# --------------------------------------------------------------------------
# training from a scene on disk, through the user's entry points


REPO = os.path.dirname(os.path.abspath(__file__))
# the scene of those records: run_gate_matrix.py's --make-scenes defaults
SCENE_ARGS = ("--hw", "200", "--n-train", "40", "--n-test", "8")
# the mixed-resolution masked scene: the masked scene above beside the
# tool's masked scene at 120^2 (16 + 2 views), one capture of two sizes
SMALL_SCENE_ARGS = ("--hw", "120", "--n-train", "16", "--n-test", "2")
BUCKET_STEPS = 200
CLI_STEPS, CLI_SAVE, CLI_RESUME_TO = 300, 150, 400
NEUS_DISK_STEPS = 200
# the kernels each from-disk path must launch (every design counted once)
NERFACTO_KERNELS = ("hash_encode_block", "hash_encode_block_bwd", "hash_encode_block_exact")
SPLAT_PATH_KERNELS = ("project_gaussians", "project_gaussians_bwd", "tile_bin", "tile_bin_bucketed",
                      "blend_saturating", "blend_saturating_bwd")
NEUS_PATH_KERNELS = ("hash_encode_flat", "hash_encode_flat_bwd")
# the rest of the nerfacto family (phases 58-60): each method, the tool's
# scene its gate runs on (tools/run_gate_matrix.py:94-105) and its own loss
# term, which must fall as the rgb loss does; cut in depth from the gates'
# 5000 steps (the full gates: their own chip calls, PERF.md)
FAMILY = (("depth-nerfacto", "basic", "depth_loss"), ("semantic-nerfw", "semantic", "semantics_loss"),
          ("phototourism", "appearance", None))
FAMILY_STEPS = 300
# the method whose kernels are also timed at its trained state: K1's
# backward over every field level, with the proposal's every step
FAMILY_TIMED = "phototourism"


def zero_counts() -> None:
    from nerfstudio_torch.ops import gather_probes as gp
    from nerfstudio_torch.ops import hash_grid as hg
    from nerfstudio_torch.ops.gsplat import _cuda as sc

    hg.reset_launch_counts()
    sc.reset_launch_counts()
    gp.reset_launch_counts()


def read_counts() -> dict:
    from nerfstudio_torch.ops import hash_grid as hg
    from nerfstudio_torch.ops.gsplat import _cuda as sc

    return {**hg.launch_counts, **sc.launch_counts}


def check_path(name, counts, want, none=PER_THREAD + ("hash_encode_block_per_thread", "blend_saturating_per_pixel")):
    """Every kernel of ``want`` launched on the path, none of ``none``."""
    missing = [k for k in want if not counts.get(k)]
    stray = {k: counts[k] for k in none if counts.get(k)}
    if missing or stray:
        raise AssertionError(f"{name}: kernels not launched {missing}, launched and not expected {stray}")


def train_losses(run_dir, key="loss") -> list:
    """The train losses (or the loss term ``key``) the writer logged for a
    run, in order."""
    with open(os.path.join(run_dir, "scalars.jsonl"), encoding="utf-8") as f:
        return [r[key] for r in map(json.loads, f) if r["prefix"] == "train"]


def start_scene(root, scene="basic", args=SCENE_ARGS):
    """Start tools/make_synthetic_dataset.py ROOT/SCENE --scene SCENE at the
    JAX gate records' protocol (``tools/run_gate_matrix.py --make-scenes``:
    SCENE_ARGS) in its own process (it reads the JAX package's numpy-only
    ply writer; without JAX_PLATFORMS that package imports no JAX). Returns
    (the process, the scene's directory, the start time)."""
    out = os.path.join(root, scene if args == SCENE_ARGS else f"{scene}_{args[1]}")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "make_synthetic_dataset.py"), out,
                             "--scene", scene, *args], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    return proc, out, time.perf_counter()


def finish_scene(name, job, log_it=True):
    """Wait for a ``start_scene`` job (raising if the tool failed) and log
    the scene; returns its directory."""
    proc, out, t0 = job
    _, err = proc.communicate()
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, proc.args, stderr=err)
    with open(os.path.join(out, "transforms.json"), encoding="utf-8") as f:
        meta = json.load(f)
    extra = {k: meta[k] for k in ("k1", "k2") if k in meta}
    masks = sum("mask_path" in fr for fr in meta["frames"])
    labels = sum("semantic_path" in fr for fr in meta["frames"])
    if log_it:
        log(name, f"the {os.path.basename(out)} scene: {len(meta['frames'])} frames of {meta['w']}x{meta['h']}"
            + (f", OpenCV {extra}" if extra else "") + (f", {masks} masks" if masks else "")
            + (f", {labels} label images of {len(meta['semantic_classes'])} classes" if labels else "")
            + f", points3D.ply; {time.perf_counter() - t0:.1f} s wall from its start to its use")
    return out


def make_scene(name, root, scene="basic", args=SCENE_ARGS, log_it=True):
    """``start_scene`` and ``finish_scene``: the scene's directory."""
    return finish_scene(name, start_scene(root, scene, args), log_it)


def make_mixed_scene(name, root, masked):
    """One masked capture of two resolutions: the tool's masked scene at
    SMALL_SCENE_ARGS (written by the tool's own PNG writer; the card has no
    Pillow) beside ``masked``, under one transforms.json with per-frame
    intrinsics and sizes (the same geometry and orbit radius, so one
    scene)."""
    t0 = time.perf_counter()
    small = make_scene(name, root, "masked", SMALL_SCENE_ARGS, log_it=False)
    out = os.path.join(root, "mixed")
    os.makedirs(out)
    frames, sizes = [], {}
    for sub, src in (("big", masked), ("small", small)):
        os.symlink(src, os.path.join(out, sub))
        with open(os.path.join(src, "transforms.json"), encoding="utf-8") as f:
            meta = json.load(f)
        per_frame = {k: meta[k] for k in ("fl_x", "fl_y", "cx", "cy", "w", "h")}
        for fr in meta["frames"]:
            frames.append(dict(fr, file_path=f"{sub}/{fr['file_path']}", mask_path=f"{sub}/{fr['mask_path']}",
                               **per_frame))
        sizes[f"{meta['w']}x{meta['h']}"] = len(meta["frames"])
    with open(os.path.join(out, "transforms.json"), "w", encoding="utf-8") as f:
        json.dump({"camera_model": "OPENCV", "frames": frames}, f)
    log(name, f"the mixed-resolution masked scene: {sizes} frames, every one masked; "
        f"{time.perf_counter() - t0:.1f} s wall")
    return out


def cli_round_trip(name, scene, root, card):
    """``scripts.train nerfacto --data SCENE`` for CLI_STEPS steps with a
    save every CLI_SAVE, a resume from that run to CLI_RESUME_TO, the eval
    of the first save (``eval_setup``) and ``scripts.eval`` of the resumed
    run. The losses must be finite and the PSNR must rise from the first
    save to the end."""
    from nerfstudio_torch.scripts import eval as eval_script
    from nerfstudio_torch.scripts import train as train_script
    from nerfstudio_torch.utils.eval_utils import eval_setup

    t0 = time.perf_counter()
    out = os.path.join(root, "runs")
    common = ["nerfacto", "--data", scene, "--trainer.output_dir", out, "--trainer.vis", "none",
              "--trainer.steps_per_eval_batch", "0", "--trainer.steps_per_eval_image", "0",
              "--trainer.steps_per_eval_all_images", "0", "--trainer.save_only_latest_checkpoint", "false",
              "--trainer.steps_per_save", str(CLI_SAVE)]
    zero_counts()
    train_script.main(common + ["--trainer.max_num_iterations", str(CLI_STEPS), "--trainer.timestamp", "run1"])
    run1 = os.path.join(out, "basic", "nerfacto", "run1")
    train_script.main(common + ["--trainer.max_num_iterations", str(CLI_RESUME_TO), "--trainer.timestamp", "run2",
                                "--trainer.load_dir", os.path.join(run1, "nerfstudio_models")])
    run2 = os.path.join(out, "basic", "nerfacto", "run2")
    _, pipeline, state = eval_setup(run1, load_step=CLI_SAVE)
    first = pipeline.get_average_eval_image_metrics(state)
    del pipeline, state
    last = eval_script.main([run2, "--output-path", os.path.join(root, "eval.json")])["results"]
    counts = read_counts()
    check_path(name, counts, NERFACTO_KERNELS)
    losses = train_losses(run1) + train_losses(run2)
    wall = time.perf_counter() - t0
    log(name, f"trained {CLI_STEPS} steps (saves at {CLI_SAVE} and {CLI_STEPS}), resumed to {CLI_RESUME_TO}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; eval over the held-out views: psnr "
        f"{first['psnr']:.2f} at step {CLI_SAVE} -> {last['psnr']:.2f} at {CLI_RESUME_TO}, ssim {first['ssim']:.3f} "
        f"-> {last['ssim']:.3f}; launches {({k: v for k, v in counts.items() if v})}; {wall:.1f} s wall on {card}")
    if not all(math.isfinite(x) for x in losses) or not last["psnr"] > first["psnr"]:
        raise AssertionError(f"{name}: losses finite {all(map(math.isfinite, losses))}, psnr {first['psnr']} -> "
                             f"{last['psnr']}")
    return dict(steps=CLI_RESUME_TO, psnr=(first["psnr"], last["psnr"]), launches=counts, wall_s=wall)


def check_splat_step(name, one_step, label, keep=None):
    """K4, K5 and K6, forward and backward, against their twins at the
    inputs that one more step of ``one_step`` hands them (each called once):
    K4 within K4_REL of each output's peak and its backward against the
    float64 twin (``k4_fwd_errors``, ``k4_bwd_errors``; with the viewmat's
    gradient where the step asked for it, ``k4_viewmat_errors``), K5 exact
    in every design (``check_k5``), K6's forward bit-equal across designs
    and within K6_FWD_REL (``check_k6_designs``), its backward within
    K6_BWD_REL. Returns {kernel: max abs err}; ``keep`` (a dict) receives
    K4 backward's inputs under "k4_bwd"."""
    from nerfstudio_torch.ops.gsplat import projection as pj
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    calls = capture_kernel_calls({"K4": (pj, "_project_kernel"), "K4 bwd": (pj, "_project_bwd_kernel"),
                                  "K5": (rz, "_tile_bin_kernel"), "K6": (rz, "_blend_kernel"),
                                  "K6 bwd": (rz, "_blend_bwd_kernel")}, one_step)
    if any(len(v) != 1 for v in calls.values()):
        raise AssertionError(f"{name}: one step called {({k: len(v) for k, v in calls.items()})}")
    (m, s, q, cam), _ = calls["K4"][0]
    out, ref, errs, flips, bad_flips, fwd_abs = k4_fwd_errors(name, m, s, q, cam)
    (bm, bs, bq, bcam, *cots), bkw = calls["K4 bwd"][0]
    if keep is not None:
        keep["k4_bwd"] = (bm, bs, bq, bcam, cots)
    bwd_errs, bwd_over, bwd_abs = k4_bwd_errors(m, s, q, cam, cots)
    log(name, f"K4 at {label}: N={m.shape[0]} ({int(ref[4].sum())} visible) {cam[5]}x{cam[6]} (limit {K4_REL}): "
        + k4_line("mode antialiased" if cam[-1] else "mode classic", errs, flips, bad_flips, bwd_errs, bwd_over))
    if max(errs.values()) > K4_REL or bad_flips or bwd_over:
        raise AssertionError(f"{name}: K4 disagrees with its twin at {label}")
    view_abs = None
    if bkw.get("need_viewmat"):
        view_abs = check_k4_viewmat(name, f"{label}, the step's own call", bm, bs, bq, bcam, cots)["max_abs_err"]
    check_k5(name, tuple(calls["K5"][0][0]), label)
    k6 = check_k6_designs(name, label, *calls["K6"][0][0])
    rel, k6_bwd_err, _, _, walked = k6_bwd_check(*calls["K6 bwd"][0][0])
    log(name, f"K6 backward at {label} (walked {walked:.0f}): " + k6_bwd_line(rel))
    if max(rel.values()) > K6_BWD_REL:
        raise AssertionError(f"{name}: K6's backward disagrees with its twin at {label}")
    errs = {"project_gaussians": fwd_abs, "project_gaussians_bwd": bwd_abs, "tile_bin": 0.0,
            "blend_saturating": k6["max_abs_err"][rz.BLEND_FWD_DESIGNS[0]], "blend_saturating_bwd": k6_bwd_err}
    if view_abs is not None:
        errs["project_gaussians_bwd_viewmat"] = view_abs
    return errs


def check_hash_step(name, one_step, label, kind):
    """K1's (``kind`` "K1") or K7's forward and backward, every design,
    against the twins at every call that one more step of ``one_step``
    makes (``check_block_designs`` or ``check_flat``; the backward against
    the float64 twin, ``bwd_designs_vs_twin``). Returns {kernel: max abs
    err}."""
    from nerfstudio_torch.ops import hash_grid as hg

    fwd, bwd = ("_block_kernel", "_block_bwd_kernel") if kind == "K1" else ("_flat_kernel", "_flat_bwd_kernel")
    calls = capture_kernel_calls({"fwd": (hg, fwd), "bwd": (hg, bwd)}, one_step)
    if not calls["fwd"] or not calls["bwd"]:
        raise AssertionError(f"{name}: one step called {kind} {({k: len(v) for k, v in calls.items()})} times")
    key = "hash_encode_block" if kind == "K1" else "hash_encode_flat"
    out = {key: 0.0, key + "_bwd": 0.0}
    for i, ((pos, table), kw) in enumerate(calls["fwd"]):
        what = f"{label}, {kind} forward call {i + 1}"
        if kind == "K1":
            errs = check_block_designs(name, kw.pop("exact"), pos, table, kw, what)[0]
        else:
            errs = check_flat(name, pos, table, kw, what)[0]
        out[key] = max(out[key], *errs.values())
    for (pos, table, g, *scales), kw in calls["bwd"]:
        needs = {k: kw.pop(k) for k in ("need_positions", "need_table")}
        designs = bwd_designs_vs_twin(f"{name}, {label}", kind, pos, table, g, kw, scales[0] if scales else None,
                                      **needs)[0]
        out[key + "_bwd"] = max(out[key + "_bwd"], *(r["max_abs_err"] for r in designs.values()))
    return out


def check_eval_chunk(name, pipeline, state, label):
    """K3 (and the proposal nets' K1) in every design against the twins at
    the inputs of the middle chunk of the first eval view, rendered in
    gate.EVAL_CHUNK-ray chunks. Returns {kernel: max abs err}."""
    from nerfstudio_torch.ops import hash_grid as hg
    from nerfstudio_torch.scripts import gate

    cam_idx = pipeline.datamanager.eval_image(0)[0]
    calls = capture_kernel_calls({"fwd": (hg, "_block_kernel")},
                                 lambda: pipeline.render_eval_camera(state, cam_idx, gate.EVAL_CHUNK))["fwd"]
    exact = [c for c in calls if c[1]["exact"]]
    pick, per_chunk = len(exact) // 2, len(calls) // max(len(exact), 1)
    if not exact or len(calls) != per_chunk * len(exact):
        raise AssertionError(f"{name}: an eval view called K3 {len(exact)} times among {len(calls)} K1/K3 calls")
    out = {"hash_encode_block": 0.0, "hash_encode_block_exact": 0.0}
    for (pos, table), kw in calls[pick * per_chunk:(pick + 1) * per_chunk]:
        ex = kw.pop("exact")
        errs = check_block_designs(name, ex, pos, table, kw, f"{label}, eval chunk {pick + 1} of {len(exact)}, "
                                   f"{'K3' if ex else 'K1'}")[0]
        k = "hash_encode_block_exact" if ex else "hash_encode_block"
        out[k] = max(out[k], *errs.values())
    return out


def profiled_idle(name, one_step, step_ms, label):
    """Device-busy time per step over PROFILED_STEPS more steps of
    ``one_step`` under the profiler, and the idle share of an unprofiled
    ``step_ms`` step; None where the profiler saw no device activity."""
    prof = profile_device(lambda: [one_step() for _ in range(PROFILED_STEPS)])
    if prof is None:
        log(name, f"{label}: torch.profiler saw no device activity: idle share not measured")
        return None
    rows, busy_ms, activities, _ = prof
    classes = {}
    for n, t in rows:
        classes[kernel_class(n)] = classes.get(kernel_class(n), 0.0) + t
    idle = 1 - busy_ms / step_ms
    log(name, f"{label}: {PROFILED_STEPS} steps under torch.profiler: {activities:.0f} device activities and "
        f"{busy_ms:.2f} ms of device-busy time per step, i.e. the device idles {idle:.1%} of the unprofiled "
        f"{step_ms:.2f} ms step (host clock, the median 1000-step block); by class (ms/step): "
        + ", ".join(f"{c} {t:.3f}" for c, t in sorted(classes.items(), key=lambda kv: -kv[1])))
    return dict(busy_ms=busy_ms, step_ms=step_ms, idle=idle, activities=activities, classes=classes)


def loss_fell(run_dir, key="loss", head_quarter=0):
    """(mean of the first quarter of the logged train losses (or of the
    term ``key``; of the quarter ``head_quarter``, counting from 0), of the
    last quarter, all finite and falling)."""
    losses = train_losses(run_dir, key)
    q = max(len(losses) // 4, 1)
    head = statistics.fmean(losses[head_quarter * q:(head_quarter + 1) * q])
    tail = statistics.fmean(losses[-q:])
    return head, tail, all(map(math.isfinite, losses)) and tail < head


def gate_phase(name, method, scene, root, card, want, steps=None, keep=None, timed=False, after=None,
               overrides=None):
    """``scripts.gate.run_gate`` at the method's gate steps on the scene: it
    fails unless PSNR > 20 and SSIM > 0.7. Prints the result beside the JAX
    record's quality (the same scene protocol), the train seconds and
    rays/s of the user's loop, the launches per step by kernel. Then, at
    the trained state: every kernel of the path against its twin at one
    more step's inputs (and, for nerfacto, one eval chunk's), and the
    device's idle share over a few profiled steps. With ``steps`` (a run cut
    in depth) the gate is not asked: the logged loss must be finite and
    fall (first quarter's mean against the last's). ``keep`` receives the
    splat step's K4 backward inputs (``check_splat_step``). With ``timed``
    (a ray method) the kernels at the trained state are also timed
    (``timed_hash_kernels``); a path without kernels (``want`` empty: plain
    neus) has none to check. ``after(run)`` runs last at the trained state
    (after the profile); its result joins the record as ``after``.
    ``overrides`` (``--a.b value`` flags) go to the gate runner."""
    from nerfstudio_torch.scripts import gate

    splat = method.startswith("splatfacto")
    undistort = undistort_host_ms(scene) if splat else None
    t0 = time.perf_counter()
    zero_counts()
    res, run = gate.run_gate(method, scene, os.path.join(root, "gate"), steps, overrides=overrides)
    counts = read_counts()
    check_path(name, counts, want, none=PER_THREAD + ("hash_encode_block_per_thread", "blend_saturating_per_pixel",
                                                    "project_gaussians_bwd_viewmat"))
    wall = time.perf_counter() - t0
    # the JAX package's record of the cell (gate.jax_record, read from
    # benchmarks/): PSNR and SSIM only; its times were taken on a TPU
    m, (jp, js) = res["metrics"], (res["jax_record"] or {"psnr": None, "ssim": None}).values()
    per_step = {k: v / res["steps"] for k, v in res["launches"]["train"].items() if v}
    head, tail, fell = loss_fell(run["base_dir"])
    config = "shipped config" if not overrides else f"shipped config with {' '.join(overrides)} (cell {res['cell']})"
    log(name, f"{method} on {res['scene']} ({' '.join(SCENE_ARGS)}), {config}, {res['steps']} steps"
        + (f" (cut in depth from {gate.GATE_STEPS[method]}: the gate is not asked; logged loss {head:.4f} -> "
           f"{tail:.4f}, first quarter's mean to the last's)" if steps else "") + ": psnr "
        f"{m['psnr']:.2f} (JAX record {jp}), ssim {m['ssim']:.3f} (JAX record {js}), over every held-out view; "
        f"gates {res['gates']} -> pass {res['pass']}; train {res['train_seconds']:.1f} s = "
        f"{res['train_rays_per_sec']:,.0f} rays/s, {1e3 / res['steps_per_sec']:.2f} ms/step (host clock, the "
        f"user's loop with its final save; per {res['step_ms_by_block']['steps_per_block']} steps: "
        f"{[round(x, 2) for x in res['step_ms_by_block']['ms']]})"
        + (f", {res['num_alive']} live gaussians at the end" if "num_alive" in res else "")
        + (f"; undistorting the {undistort['images']} train images of {undistort['hw']} on the host took "
           f"{undistort['ms']:.1f} ms" if undistort else "")
        + f"; launches per train step {per_step}, eval {({k: v for k, v in res['launches']['eval'].items() if v})}; "
        f"{wall:.1f} s wall on {card}")
    print(json.dumps(res), flush=True)
    if steps and not fell:
        raise AssertionError(f"{name}: {method}'s loss did not fall over {steps} steps: {head} -> {tail}")
    if not steps and not res["pass"]:
        raise AssertionError(f"{name}: {method} missed the gate: psnr {m['psnr']}, ssim {m['ssim']}")
    label = f"the {method} {'run' if steps else 'gate'}'s trained state"
    kernels = None
    if splat:
        errs = check_splat_step(name, run["one_step"], label, keep)
    elif not want:
        errs = {}  # plain neus: the SDF field and NeuSSampler are plain PyTorch
    elif timed:
        errs, kernels = timed_hash_kernels(name, run, label, card)
    else:
        errs = check_hash_step(name, run["one_step"], label, "K1")
        for k, v in check_eval_chunk(name, run["pipeline"], run["state"], label).items():
            errs[k] = max(errs.get(k, 0.0), v)
    step_ms = statistics.median(res["step_ms_by_block"]["ms"][:-1] or res["step_ms_by_block"]["ms"])
    idle = profiled_idle(name, run["one_step"], step_ms, label)
    extra = None if after is None else after(run)
    del run
    torch.cuda.empty_cache()
    return dict(res, gate_launches=res["launches"], launches=counts, wall_s=wall, max_abs_err=errs, idle=idle,
                undistort=undistort, loss=(head, tail), kernels=kernels, after=extra)


def neus_from_disk(name, scene, root, card):
    """neus-facto through ``factory.build_trainer`` and ``Trainer.train`` on
    the scene for NEUS_DISK_STEPS steps: losses finite and falling (the mean
    of the last 20 below the first 20's), two K7 forward and two backward
    launches per step."""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.pipelines.factory import build_trainer

    t0 = time.perf_counter()
    config = get_method("neus-facto")
    config.data = scene
    t = config.trainer
    t.output_dir, t.timestamp, t.vis, t.max_num_iterations = os.path.join(root, "runs"), "neus", "none", NEUS_DISK_STEPS
    t.steps_per_eval_batch = t.steps_per_eval_image = t.steps_per_eval_all_images = t.steps_per_save = 0
    trainer = build_trainer(config)
    losses, step_once = [], trainer.train_iteration

    def iteration(step):
        metrics = step_once(step)
        losses.append(metrics["loss"])
        return metrics

    trainer.train_iteration = iteration
    zero_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    counts = read_counts()
    check_path(name, counts, NEUS_PATH_KERNELS)
    losses = [float(x) for x in losses]
    head, tail = statistics.fmean(losses[:20]), statistics.fmean(losses[-20:])
    per_step = {k: counts[k] / NEUS_DISK_STEPS for k in NEUS_PATH_KERNELS}
    wall = time.perf_counter() - t0
    log(name, f"{NEUS_DISK_STEPS} steps through the trainer, {config.datamanager.train_num_rays_per_batch} rays: "
        f"loss mean of the first 20 {head:.4f}, of the last 20 {tail:.4f}; launches per step {per_step}; "
        f"{train_s * 1e3 / NEUS_DISK_STEPS:.1f} ms/step (host clock, with the final save); {wall:.1f} s wall on {card}")
    if not all(map(math.isfinite, losses)) or not tail < head or per_step != dict.fromkeys(NEUS_PATH_KERNELS, 2.0):
        raise AssertionError(f"{name}: losses finite and falling, two K7 launches each way per step expected")
    trainer.train_iteration = step_once
    errs = check_hash_step(name, lambda: trainer.train_iteration(int(trainer.state.step)),
                           "neus-facto's trained state", "K7")
    del trainer
    torch.cuda.empty_cache()
    return dict(steps=NEUS_DISK_STEPS, loss=(head, tail), launches=counts, wall_s=wall, max_abs_err=errs)


# --------------------------------------------------------------------------
# cameras beyond the pinhole, the samplers, distorted and masked captures

RAYGEN_HW = 512
RAYGEN_RAYS = 1 << 16  # random pixels of the batch with a camera each
# Card vs CPU, the same float32 ops in the same order: origins and unit
# directions within 1e-5 abs (transcendentals and the Newton and Fisheye624
# solves may differ by ulps), the direction norms within 1e-5 relative, the
# pixel areas within 1e-3 of the largest (a difference of two neighbouring
# directions ~1e-3 apart) or of a nominal pixel's (1 / f)^2, whichever is
# larger: VR180's rays do not move with x, so its areas are ~0 up to the
# rounding of its sines (in the reference too).
RAYGEN_ATOL = 1e-5
RAYGEN_AREA_REL = 1e-3
OPENCV_TERMS = (-0.18, 0.04, 0.01, -0.002, 1e-3, -2e-3)  # k1..k4, p1, p2: all six non-zero
FISHEYE_TERMS = (0.05, -0.01, 0.002, -1e-4, 0.0, 0.0)
FISHEYE624_TERMS = (0.03, -0.01, 0.002, -1e-4, 1e-5, -1e-6, 1e-3, -5e-4, 2e-4, -1e-4, 1e-4, -5e-5)


def raygen_cases():
    """{label: (camera types, distortion row or None)}: every camera type,
    and one batch mixing every type that takes six parameters."""
    from nerfstudio_torch.cameras.cameras import CameraType as T

    one = {"perspective, OpenCV 6 terms": (T.PERSPECTIVE, OPENCV_TERMS), "fisheye": (T.FISHEYE, FISHEYE_TERMS),
           "equirectangular": (T.EQUIRECTANGULAR, None), "ODS L": (T.OMNIDIRECTIONALSTEREO_L, None),
           "ODS R": (T.OMNIDIRECTIONALSTEREO_R, None), "VR180 L": (T.VR180_L, None), "VR180 R": (T.VR180_R, None),
           "orthophoto": (T.ORTHOPHOTO, None), "FISHEYE624, 12 terms": (T.FISHEYE624, FISHEYE624_TERMS)}
    cases = {k: ([t] * 2, d) for k, (t, d) in one.items()}
    cases["mixed (every type but FISHEYE624)"] = ([t for t, d in one.values() if t != T.FISHEYE624], OPENCV_TERMS)
    return cases


def raygen_cameras(types, d, device):
    """Cameras of ``types`` at RAYGEN_HW^2 with random poses and
    intrinsics (numpy seed), the distortion row ``d`` for each."""
    from nerfstudio_torch.cameras.cameras import Cameras

    n = len(types)
    rng = np.random.default_rng(SEED + 3)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    c2w = np.concatenate([q, rng.uniform(-2, 2, (n, 3, 1))], axis=-1).astype(np.float32)
    f = rng.uniform(0.8, 1.1, (2, n)).astype(np.float32) * RAYGEN_HW
    c = (RAYGEN_HW / 2 + rng.uniform(-8, 8, (2, n))).astype(np.float32)
    dist = None if d is None else np.tile(np.asarray(d, np.float32), (n, 1))
    return Cameras.create(c2w, f[0], f[1], c[0], c[1], RAYGEN_HW, RAYGEN_HW, distortion_params=dist,
                          camera_type=torch.tensor([t.value for t in types]), device=device)


def small_poses(n, gen):
    """n random (3, 4) rigid corrections: rotations of ~0.05 rad (the
    exponential of a random skew matrix), translations of ~0.02."""
    a = torch.randn((n, 3), generator=gen) * 0.05
    skew = torch.zeros((n, 3, 3))
    skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -a[:, 2], a[:, 1], -a[:, 0]
    skew = skew - skew.transpose(1, 2)
    return torch.cat([torch.linalg.matrix_exp(skew), torch.randn((n, 3, 1), generator=gen) * 0.02], dim=-1)


def bundle_errors(a, b, nominal_area):
    """Card bundle ``a`` against CPU bundle ``b``; the pixel areas against
    the larger of their peak and ``nominal_area``."""
    area = max(float(b.pixel_area.abs().max()), nominal_area)
    return {"origins": float((a.origins.cpu() - b.origins).abs().max()),
            "directions": float((a.directions.cpu() - b.directions).abs().max()),
            "pixel_area": float((a.pixel_area.cpu() - b.pixel_area).abs().max() / area),
            "directions_norm": float(((a.metadata["directions_norm"].cpu() - b.metadata["directions_norm"])
                                      / b.metadata["directions_norm"]).abs().max())}


def raygen_phase(name, card):
    """Every camera type's rays on the card against the CPU: one full
    RAYGEN_HW^2 image per case through ``generate_rays``, then RAYGEN_RAYS
    random pixels with a camera each through ``generate_rays_from_coords``,
    without and with a camera-opt pose correction and a distortion delta
    per ray. Returns {case: worst errors} and the card ms of each full
    image."""
    gen = torch.Generator().manual_seed(SEED + 4)
    worst, rows = {}, []
    for label, (types, d) in raygen_cases().items():
        cams = {dev: raygen_cameras(types, d, dev) for dev in ("cuda", "cpu")}
        nominal = float(cams["cpu"].fx.max()) ** -2
        errs = {"full image": bundle_errors(cams["cuda"].generate_rays(1), cams["cpu"].generate_rays(1), nominal)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cams["cuda"].generate_rays(1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = len(types)
        idx = torch.stack([torch.randint(0, n, (RAYGEN_RAYS,), generator=gen),
                           torch.randint(0, RAYGEN_HW, (RAYGEN_RAYS,), generator=gen),
                           torch.randint(0, RAYGEN_HW, (RAYGEN_RAYS,), generator=gen)], dim=-1)
        coords = idx[:, 1:].float() + 0.5
        opt = small_poses(RAYGEN_RAYS, gen)
        width = 6 if d is None else len(d)
        delta = torch.randn((RAYGEN_RAYS, width), generator=gen) * 1e-3
        for what, o, dd in (("pixels", None, None), ("pixels, camera opt", opt, None),
                            ("pixels, distortion delta", None, delta), ("pixels, both", opt, delta)):
            a, b = (cams[dev].generate_rays_from_coords(idx[:, :1].to(dev), coords.to(dev),
                                                        None if o is None else o.to(dev),
                                                        None if dd is None else dd.to(dev))
                    for dev in ("cuda", "cpu"))
            errs[what] = bundle_errors(a, b, nominal)
        worst[label] = {k: max(e[k] for e in errs.values()) for k in next(iter(errs.values()))}
        worst[label]["full_image_ms"] = ms
        rows.append(f"{label}: " + ", ".join(f"{k} {v:.2g}" for k, v in worst[label].items()))
    log(name, f"{RAYGEN_HW}^2 images and {RAYGEN_RAYS} random pixels with a camera each, without and with a "
        f"camera-opt pose and a distortion delta per ray, card vs CPU (limits: origins, directions {RAYGEN_ATOL} abs, "
        f"norms {RAYGEN_ATOL} rel, pixel area {RAYGEN_AREA_REL} of the peak or of (1 / f)^2; full-image ms on the card, host "
        f"clock, on {card}): " + "; ".join(rows))
    bad = {k: v for k, v in worst.items() if max(v["origins"], v["directions"], v["directions_norm"]) > RAYGEN_ATOL
           or v["pixel_area"] > RAYGEN_AREA_REL or not all(map(math.isfinite, v.values()))}
    if bad:
        raise AssertionError(f"{name}: card rays disagree with the CPU's: {bad}")
    return worst


SAMPLE_IMAGES, SAMPLE_HW, SAMPLE_RAYS = 8, 200, 4096


def sample_data(gen):
    """Random uint8 images, masks without each image's left quarter, and
    a split of two resolutions (SAMPLE_HW^2 and 120^2) as buckets."""
    images = torch.randint(0, 256, (SAMPLE_IMAGES, SAMPLE_HW, SAMPLE_HW, 3), generator=gen, dtype=torch.uint8)
    masks = np.ones((SAMPLE_IMAGES, SAMPLE_HW, SAMPLE_HW, 1), bool)
    masks[:, :, : SAMPLE_HW // 4] = False
    buckets = []
    for hw, ids in ((SAMPLE_HW, [0, 2, 3, 5, 6]), (120, [1, 4, 7])):
        m = np.ones((len(ids), hw, hw, 1), bool)
        m[:, :, : hw // 4] = False
        buckets.append({"images": torch.randint(0, 256, (len(ids), hw, hw, 3), generator=gen,
                                                dtype=torch.uint8).numpy(),
                        "camera_indices": np.asarray(ids, np.int32), "masks": m})
    return images, masks, buckets


def sampling_phase(name, card):
    """The sampling paths on the card against the CPU with the same draws
    handed in (drawn on the CPU), exact on the indices and the pixels: the
    fisheye, equirectangular, patch and pair samplers, the masked table,
    the masked, bucketed and masked-bucket batches of the datamanager, and
    a resident subset before and after a reload. Each manager also draws
    from the card's own generator: every index in range, and masked ones
    on valid pixels."""
    import copy as copy_lib

    from nerfstudio_torch.cameras.cameras import Cameras
    from nerfstudio_torch.data import pixel_samplers as ps
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager

    gen = torch.Generator().manual_seed(SEED + 5)
    n, hw, r = SAMPLE_IMAGES, SAMPLE_HW, SAMPLE_RAYS
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen)  # noqa: E731
    ru = lambda shape: torch.rand(shape, generator=gen)  # noqa: E731
    samplers = {
        "fisheye": (ps.sample_pixel_indices_fisheye, (r, n, hw, hw), (ri(0, n, (r,)), ru((r,)), ru((r,)))),
        "equirectangular": (ps.sample_pixel_indices_equirectangular, (r, n, hw, hw),
                            (ri(0, n, (r,)), ru((r,)), ri(0, hw, (r,)))),
        "patch": (ps.sample_patch_pixel_indices, (r, 8, n, hw, hw),
                  (ri(0, n, (r // 64,)), ri(0, hw - 7, (r // 64,)), ri(0, hw - 7, (r // 64,)))),
        "pair": (ps.sample_pair_pixel_indices, (r, n, hw, hw),
                 (ri(0, n, (r // 2,)), ri(2, hw - 2, (r // 2,)), ri(2, hw - 2, (r // 2,)), ri(-2, 3, (r // 2, 2)))),
    }
    results, bad = {}, []
    for label, (fn, args, draws) in samplers.items():
        a, b = (fn(*args, draws=tuple(x.to(dev) for x in draws)) for dev in ("cuda", "cpu"))
        results[label] = dict(equal=bool(torch.equal(a.cpu(), b)), rows=int(b.shape[0]))
    images, masks, buckets = sample_data(gen)
    sizes = np.array([120 if i in (1, 4, 7) else hw for i in range(n)])
    cams = {k: Cameras.create(np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1)), hw, hw, hw / 2, hw / 2, w, w,
                              device="cpu") for k, w in (("flat", hw), ("bucketed", sizes))}
    managers = {
        "masked": lambda cfg, dev: DeviceCacheDataManager(cfg, cams["flat"], images, dev, masks=masks),
        "bucketed": lambda cfg, dev: DeviceCacheDataManager(
            cfg, cams["bucketed"], device=dev, buckets=[{k: v for k, v in b.items() if k != "masks"} for b in buckets]),
        "masked buckets": lambda cfg, dev: DeviceCacheDataManager(cfg, cams["bucketed"], device=dev,
                                                                  buckets=copy_lib.deepcopy(buckets)),
        "resident subset": lambda cfg, dev: DeviceCacheDataManager(cfg, cams["flat"], images, dev),
    }
    valid = torch.from_numpy(ps.build_valid_indices(masks)).long()
    pick = ri(0, valid.shape[0], (r,))
    a, b = (ps.sample_pixel_indices_from_valid(r, valid.to(dev), draws=(pick.to(dev),)) for dev in ("cuda", "cpu"))
    results["masked table"] = dict(equal=bool(torch.equal(a.cpu(), b)), rows=r)
    for label, make in managers.items():
        cfg = DataManagerConfig(train_num_rays_per_batch=r, max_images_in_memory=3 if label == "resident subset"
                                else None, steps_per_reload=10)
        dms = {dev: make(cfg, dev) for dev in ("cuda", "cpu")}
        rec = {}
        for when in (("before reload", "after reload") if label == "resident subset" else ("batch",)):
            if when == "after reload":
                for dm in dms.values():
                    dm.maybe_reload(10)
                rec["resident_map_equal"] = bool(torch.equal(dms["cuda"].resident_map.cpu(),
                                                             dms["cpu"].resident_map))
            cpu = dms["cpu"]
            if isinstance(cpu.train_images, tuple):  # each bucket's (slot, row, col): from its table, or uniform
                alloc = cpu._bucket_ray_alloc(r)
                if cpu.bucket_valid is not None:
                    draws = tuple(v[ri(0, v.shape[0], (k,))] for v, k in zip(cpu.bucket_valid, alloc))
                else:
                    draws = tuple(torch.stack([ri(0, hi, (k,)) for hi in im.shape[:3]], dim=-1)
                                  for im, k in zip(cpu.train_images, alloc))
            elif cpu.valid_indices is not None:
                draws = cpu.valid_indices[pick]
            else:
                draws = torch.stack([ri(0, 3, (r,)), ri(0, hw, (r,)), ri(0, hw, (r,))], dim=-1)
            (ia, ba), (ib, bb) = (dm.sample_train_batch(num_rays=r, indices=draws) for dm in dms.values())
            rec[when] = bool(torch.equal(ia.cpu(), ib) and torch.equal(ba["image"].cpu(), bb["image"]))
        own, _ = dms["cuda"].sample_train_batch(torch.Generator(device="cuda").manual_seed(SEED), num_rays=r)
        own = own.cpu()
        cam = dms["cpu"].train_cameras
        h, w = cam.height[own[:, 0], 0].long(), cam.width[own[:, 0], 0].long()
        rec["own_draws_valid"] = bool((own.min() >= 0) and (own[:, 1] < h).all() and (own[:, 2] < w).all()
                                      and ("masked" not in label or (own[:, 2] >= w // 4).all()))
        results[label] = rec
    for label, rec in results.items():
        if not all(v for k, v in rec.items() if k != "rows"):
            bad.append(label)
    log(name, f"{r} rays per path, card vs CPU with the CPU's draws handed in (exact on indices and pixels): "
        + "; ".join(f"{k}: {v}" for k, v in results.items()) + f"; on {card}")
    if bad:
        raise AssertionError(f"{name}: the card's sampling disagrees with the CPU's on {bad}")
    return results


def undistort_host_ms(scene):
    """Host ms of ``maybe_undistort_dataset`` on the gate's train split of
    ``scene`` (decoding excluded); None where its cameras carry no
    distortion."""
    from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
    from nerfstudio_torch.data.datasets import InputDataset
    from nerfstudio_torch.data.undistort import maybe_undistort_dataset

    ds = InputDataset(NerfstudioDataParserConfig(data=scene, train_split_fraction=0.9, downscale_factor=1)
                      .setup().get_dataparser_outputs("train"))
    if not ds.cameras.distorted:
        return None
    images = ds.load_all()["images"]
    t0 = time.perf_counter()
    maybe_undistort_dataset(images, ds.cameras)
    return dict(ms=(time.perf_counter() - t0) * 1e3, images=int(images.shape[0]), hw=list(images.shape[1:3]))


def bucketed_run(name, scene, root, card):
    """nerfacto at the shipped config through ``factory.build_trainer`` and
    ``Trainer.train`` for BUCKET_STEPS steps on the mixed-resolution masked
    scene (one resolution bucket per size, each drawing from its mask-valid
    table): losses finite and falling (the mean of the last 20 below the
    first 20's); then one step from the trained weights (flat hash tables,
    as phase 11) on the card and on the CPU twins with the same draws, at
    phase 11's limits."""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.engine.trainer import aux_from_state, aux_state
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.models.nerfacto import NerfactoModel
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws
    from nerfstudio_torch.pipelines.factory import build_pipeline, build_trainer

    def configure(device_type):
        config = get_method("nerfacto")
        config.data = scene
        config.machine.device_type = device_type
        t = config.trainer
        t.output_dir, t.timestamp, t.vis, t.max_num_iterations = os.path.join(root, "runs"), "buckets", "none", \
            BUCKET_STEPS
        t.steps_per_eval_batch = t.steps_per_eval_image = t.steps_per_eval_all_images = t.steps_per_save = 0
        return config

    t0 = time.perf_counter()
    config = configure("cuda")
    trainer = build_trainer(config)
    dm = trainer.pipeline.datamanager
    if not isinstance(dm.train_images, tuple) or dm.bucket_valid is None:
        raise AssertionError(f"{name}: the mixed-resolution masked scene did not load as masked buckets")
    shapes = [tuple(im.shape[:3]) for im in dm.train_images]
    losses, step_once = [], trainer.train_iteration

    def iteration(step):
        metrics = step_once(step)
        losses.append(metrics["loss"])
        return metrics

    trainer.train_iteration = iteration
    zero_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    counts = read_counts()
    check_path(name, counts, ("hash_encode_block", "hash_encode_block_bwd"))
    losses = [float(x) for x in losses]
    head, tail = statistics.fmean(losses[:20]), statistics.fmean(losses[-20:])
    trainer.train_iteration = step_once
    # one step on the card and on the CPU from the same weights and draws
    gen = torch.Generator().manual_seed(SEED + 6)
    flatten_tables(trainer.pipeline.model, torch.Generator().manual_seed(SEED + 7))
    weights = {k: v.detach().cpu().clone() for k, v in trainer.pipeline.model.state_dict().items()}
    cpu_pipe, cpu_state, _ = build_pipeline(configure("cpu"))
    cpu_pipe.model.load_state_dict(weights)
    cpu_state.aux = aux_from_state(cpu_state.aux, aux_state(trainer.state.aux), torch.device("cpu"))
    cdm = cpu_pipe.datamanager
    pixels = tuple(v[torch.randint(0, v.shape[0], (k,), generator=gen)]
                   for v, k in zip(cdm.bucket_valid, cdm._bucket_ray_alloc(CHECK_RAYS)))
    uniforms = [torch.rand((CHECK_RAYS, 1), generator=gen) for _ in range(3)]
    kwargs = NerfactoModel.step_kwargs(300, config.model)  # live proposals, full field backward
    runs = []
    for pipe, state, dev in ((trainer.pipeline, trainer.state, "cuda"), (cpu_pipe, cpu_state, "cpu")):
        draws = StepDraws(tuple(p.to(dev) for p in pixels),
                          SamplerUniforms(uniforms[0].to(dev), tuple(u.to(dev) for u in uniforms[1:])))
        metrics = pipe.train_step(state, draws=draws, **kwargs)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu().double() for n, p in pipe.model.named_parameters()}))
    (m_card, g_card), (m_cpu, g_cpu) = runs
    loss_rel, grad_rel, table_rel = step_rel(m_card, g_card, m_cpu, g_cpu, cpu_pipe.model)
    wall = time.perf_counter() - t0
    log(name, f"{BUCKET_STEPS} steps through the trainer at {config.datamanager.train_num_rays_per_batch} rays "
        f"over buckets {shapes} (rays per bucket {dm._bucket_ray_alloc(config.datamanager.train_num_rays_per_batch)}"
        f", from their mask-valid tables): loss mean of the first 20 {head:.4f}, of the last 20 {tail:.4f}; "
        f"{train_s * 1e3 / BUCKET_STEPS:.1f} ms/step (host clock, with the final save); one step of "
        f"{CHECK_RAYS} rays card vs CPU: loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, "
        f"limit {STEP_LOSS_RTOL}), gradients {grad_rel:.3g} of the peak (limit {STEP_GRAD_REL}), tables per level "
        f"and feature {table_rel:.3g} (limit {STEP_TABLE_SUM_REL}); {wall:.1f} s wall on {card}")
    if not all(map(math.isfinite, losses)) or not tail < head:
        raise AssertionError(f"{name}: losses finite and falling expected: {head} -> {tail}")
    if loss_rel > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL or table_rel > STEP_TABLE_SUM_REL:
        raise AssertionError(f"{name}: the card's step disagrees with the CPU's")
    del trainer, cpu_pipe
    torch.cuda.empty_cache()
    return dict(steps=BUCKET_STEPS, buckets=shapes, loss=(head, tail), launches=counts, wall_s=wall,
                card_vs_cpu=dict(loss_rel=loss_rel, grad_rel=grad_rel, table_rel=table_rel))


# --------------------------------------------------------------------------
# splatfacto's options and methods (phases 47-52): K4 with the viewmat
# gradient, K8 and the bilateral grid, MCMC, splatfacto-big


K4_VIEW_SLOTS = 1_000_000  # splatfacto-big and splatfacto-mcmc's max_gaussians
# K4 backward's viewmat gradient against a float64 run of the twin: a sum
# over every gaussian of ~60 products each, reduced in another order than
# autograd's. Per entry the kernel may be off by twice the float32 twin's
# own error plus 32 float32 roundings of the sum of the entry's |terms|
# (float64, from one viewmat per gaussian): the reduction's depth is below
# 32 at 2^20 gaussians. The other arrays keep k4_bwd_errors' limit.
K4_VIEW_ROUNDINGS = 32
# K8 and the bilateral grid, card vs CPU: the same float32 operations, so
# values within 1e-6; the gathers' cotangents are scattered with atomics in
# any order on the card: gradients within 1e-5 of their peak.
# color_correct is a 10x10 ridge solve in float32 whose normal equations sum
# every pixel, each device in its own order, and the solve amplifies those
# roundings: each device's fit is held to a float64 fit of the same inputs,
# the card's error within COLOR_CORRECT_FACTOR times the CPU's plus 1e-5.
K8_VALUE_ABS, K8_GRAD_REL, COLOR_CORRECT_FACTOR = 1e-6, 1e-5, 4.0
OPTIONS_STEPS = 400  # the three options' run through scripts.gate's loop
OPTIONS_FLAGS = ("--model.use-bilateral-grid", "True", "--model.camera-optimizer-mode", "SO3xR3",
                 "--model.use-scale-regularization", "True")
# every gate of phases 36-51 (nerfacto and splatfacto on basic, distorted
# and masked; splatfacto-mcmc and -big), cut in depth (their full runs:
# PERF.md §6): 600, past the splat methods' first refine at step 500, to
# fit phases 61-67
CUT_GATE_STEPS = 600
# nerfacto's gates on distorted and masked (phases 42 and 44): 300, as the
# nerfacto family's (their loss must fall)
NERF_CUT_STEPS = 300


def k4_view_random(n, gen, hw=SPLAT_HW):
    """``n`` random gaussians in front of the first orbit camera at hw^2
    (means in the orbit's view, scales exp(U(-5, -2)), normal quaternions),
    that camera's K4 arguments with its viewmat on the card, and
    cotangents on the visible ones: (m, s, q, cam, cots)."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    dev = torch.device("cuda")
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    m = (u(n, 3) - 0.5) * 3.0
    s = torch.exp(u(n, 3) * 3.0 - 5.0)
    q = torch.randn((n, 4), generator=gen, device=dev)
    cams = orbit_cameras(1, hw, "cpu", radius=2.5, height=1.2)
    fx, fy, cx, cy = (float(getattr(cams, f)[0, 0]) for f in ("fx", "fy", "cx", "cy"))
    cam = (pj.get_viewmat(cams.camera_to_worlds[0]).to(dev), fx, fy, cx, cy, hw, hw, 0.01, 0.3, False)
    with torch.no_grad():
        out = pj._project_kernel(m, s, q, cam)
    valid = out[4]
    cots = [torch.randn(t.shape, generator=gen, device=dev) * valid.view(-1, *([1] * (t.ndim - 1)))
            for t in out[:3] + out[5:]]
    return m, s, q, cam, cots


def k4_viewmat_errors(m, s, q, cam, cots):
    """K4's backward with the viewmat gradient at one call's inputs against
    a float64 run of the twin: (the kernel's outputs, {array: (kernel's,
    float32 twin's error / peak)}, the arrays over their limits, the
    viewmat's worst error / limit, max |kernel - float32 twin|)."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    cam = (cam[0].to(m.device),) + tuple(cam[1:])
    got = pj._project_bwd_kernel(m, s, q, cam, *cots, need_viewmat=True)
    twin = pj._project_twin_bwd(m, s, q, cam, *cots, need_viewmat=True)
    d64 = (m.double(), s.double(), q.double())
    c64 = [c.double() for c in cots]
    ref64 = pj._project_twin_bwd(*d64, cam, *c64, need_viewmat=True)
    per = pj._project_twin_bwd(*d64, (cam[0].double().expand(m.shape[0], 4, 4),) + cam[1:], *c64,
                               need_viewmat=True)[3]
    abs_sum = per.abs().sum(0)
    del per
    torch.cuda.synchronize()
    over, errs, max_abs, view_ratio = [], {}, 0.0, 0.0
    for k, a, b, r in zip(("means", "scales", "quats", "viewmat"), got, twin, ref64):
        e_k, e_t = (a.double() - r).abs(), (b.double() - r).abs()
        peak = float(r.abs().max())
        errs[k] = (float(e_k.max()) / peak, float(e_t.max()) / peak)
        max_abs = max(max_abs, float((a - b).abs().max()))
        if k == "viewmat":
            lim = 2 * e_t + K4_VIEW_ROUNDINGS * U32 * abs_sum
            view_ratio = float((e_k[:3] / lim[:3].clamp_min(1e-300)).max())
            bad = view_ratio > 1 or bool(a[3].any())
        else:
            bad = float(e_k.max()) > 2 * float(e_t.max()) + 1e-6 * peak
        if bad or not torch.isfinite(a).all():
            over.append(k)
    return got, errs, over, view_ratio, max_abs


def check_k4_viewmat(name, label, m, s, q, cam, cots):
    """``k4_viewmat_errors`` at one input set, logged; raises over a limit.
    Also checks that two runs give the same bits. Returns its record."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    got, errs, over, view_ratio, max_abs = k4_viewmat_errors(m, s, q, cam, cots)
    again = pj._project_bwd_kernel(m, s, q, (cam[0].to(m.device),) + tuple(cam[1:]), *cots, need_viewmat=True)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(name, f"K4 bwd with the viewmat gradient at {label}: N={m.shape[0]} ({int((cots[0] != 0).any(-1).sum())} with a "
        f"cotangent) {cam[5]}x{cam[6]}: max |x - float64 twin| / peak (kernel, float32 twin) "
        + ", ".join(f"{k} {a:.3g}/{b:.3g}" for k, (a, b) in errs.items())
        + f"; viewmat worst error / limit (2 x twin + {K4_VIEW_ROUNDINGS} U32 sum|terms|) {view_ratio:.3g}; two runs "
        f"bit-equal {same}; over the limit: {over}")
    if over or not same:
        raise AssertionError(f"{name}: K4's viewmat backward disagrees with the float64 twin at {label}")
    return dict(inputs=label, n=int(m.shape[0]), errs=errs, view_ratio=view_ratio, max_abs_err=max_abs,
                bit_equal_runs=same)


def k4_bwd_bounds(m, s, q, cots, antialiased):
    """(bound without, with the viewmat gradient) of K4's backward: the
    gaussians and the cotangents it reads once (d_comp, ``cots[3]``, only
    when antialiased, as the kernel reads it), the gradients written once;
    with the viewmat gradient also the viewmat's 12 floats read, the
    per-block partials written and read back and d(viewmat)'s 12 floats
    written. ~700 float32 operations per gaussian, ~100 more for the
    viewmat's 12 sums."""
    from nerfstudio_torch.ops.gsplat import _cuda as sc

    n = m.shape[0]
    moved = nbytes(m, s, q, *(cots if antialiased else cots[:3]), m, s, q)
    partials = sc.kernel_library().nst_gsplat_view_partials(n)
    return bound(moved, 700 * n), bound(moved + 4 * (12 + 2 * partials + 12), 800 * n)


def time_k4_viewmat(name, m, s, q, cam, cots, label):
    """K4's backward at the same inputs along its three routes, in turns:
    without the viewmat gradient from the host's viewmat (the default
    path) and from the card's, and with the gradient (the card's). Each by
    CUDA events around one call (median), around 50 calls back to back,
    and profiler device ms, the mean per kernel record of the backward
    kernel and of the viewmat's reducing kernel (robust to dropped records,
    ``kernel_records_ms``); the twin with the gradient, once."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    host = (cam[0].cpu(),) + tuple(cam[1:])
    dev = (cam[0].to(m.device),) + tuple(cam[1:])
    fns = {"default": lambda: pj._project_bwd_kernel(m, s, q, host, *cots),
           "device_viewmat": lambda: pj._project_bwd_kernel(m, s, q, dev, *cots),
           "viewmat": lambda: pj._project_bwd_kernel(m, s, q, dev, *cots, need_viewmat=True)}
    rec = {}
    for _ in range(2):
        for k, fn in fns.items():
            r = rec.setdefault(k, {"ms": [], "batch_ms": [], "device_ms": [], "bwd_record_ms": [],
                                   "reduce_record_ms": []})
            r["ms"].append(median_ms(fn))
            r["batch_ms"].append(batch_ms(fn))
            r["bwd_record_ms"].append(kernel_records_ms(fn, "project_bwd")[0])
            r["reduce_record_ms"].append(kernel_records_ms(fn, "view_reduce")[0] if k == "viewmat" else 0.0)
            r["device_ms"].append(r["bwd_record_ms"][-1] + r["reduce_record_ms"][-1])
    plain_ms = median_ms(lambda: pj._project_twin_bwd(m, s, q, dev, *cots, need_viewmat=True), runs=3, warmup=1)
    out = {k: {kk: statistics.fmean(v) for kk, v in r.items()} for k, r in rec.items()}
    b_default, b_view = k4_bwd_bounds(m, s, q, cots, cam[-1])
    log(name, f"K4 bwd at {label} (N={m.shape[0]}) on {card_line()}, in turns (events one call / 50 back to back / "
        f"device ms): default (the host's viewmat) " + " / ".join(f"{out['default'][k]:.4f}" for k in
                                                                   ("ms", "batch_ms", "device_ms"))
        + ", the card's viewmat without the gradient " + " / ".join(f"{out['device_viewmat'][k]:.4f}" for k in
                                                                      ("ms", "batch_ms", "device_ms"))
        + ", with the viewmat gradient " + " / ".join(f"{out['viewmat'][k]:.4f}" for k in
                                                     ("ms", "batch_ms", "device_ms"))
        + f" (the backward kernel {out['viewmat']['bwd_record_ms']:.4f}, the viewmat's sum "
        f"{out['viewmat']['reduce_record_ms']:.4f}); bounds {b_default[0]:.4f} / {b_view[0]:.4f} ms ({b_view[1]}); "
        f"twin with the viewmat {plain_ms:.3f} ms")
    return dict(inputs=label, n=int(m.shape[0]), plain_ms=plain_ms, bound=b_view, default_bound=b_default, **out)


def k8_card_vs_cpu(name, gen):
    """K8 (``grid_sample_1d/2d/3d``, ``resize_linear``) and the bilateral
    slice with their gradients, and one ``color_correct``, on the card
    against the CPU from the same inputs, at the bilateral grid's shapes
    (a (12, 8, 16, 16) grid over 512^2 pixels). Returns the worst value
    and gradient errors."""
    from nerfstudio_torch.model_components import bilateral_grid as bg
    from nerfstudio_torch.ops import interp

    g = torch.Generator().manual_seed(SEED + 11)
    hw = SPLAT_HW
    cases = {
        "grid_sample_1d": (interp.grid_sample_1d, (torch.randn(12, 16, generator=g),
                                                   torch.rand(hw * hw, generator=g) * 2.6 - 1.3)),
        "grid_sample_2d": (interp.grid_sample_2d, (torch.randn(12, 16, 16, generator=g),
                                                   torch.rand(hw * hw, 2, generator=g) * 2.6 - 1.3)),
        "grid_sample_3d": (interp.grid_sample_3d, (torch.randn(12, 8, 16, 16, generator=g),
                                                   torch.rand(hw * hw, 3, generator=g) * 2.6 - 1.3)),
        "resize_linear up": (lambda x: interp.resize_linear(x, (16, 32, 32)),
                             (torch.randn(12, 8, 16, 16, generator=g),)),
        "resize_linear down": (lambda x: interp.resize_linear(x, (4, 8, 5)),
                               (torch.randn(12, 8, 16, 16, generator=g),)),
        "slice_bilateral_grid": (bg.slice_bilateral_grid, (
            bg.init_bilateral_grid(1, device="cpu")[0] + torch.randn(12, 8, 16, 16, generator=g) * 0.1,
            torch.rand(hw, hw, 3, generator=g))),
    }
    rec, lines = {}, []
    for label, (fn, args) in cases.items():
        runs = []
        for device in ("cuda", "cpu"):
            leaves = [a.to(device).requires_grad_(True) for a in args]
            out = fn(*leaves)
            cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED + 12)).to(device)
            grads = torch.autograd.grad(out, leaves, cot)
            runs.append((out.detach().cpu(), [x.cpu() for x in grads]))
        (o_card, g_card), (o_cpu, g_cpu) = runs
        v_err = float((o_card - o_cpu).abs().max())
        g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_card, g_cpu) if b.abs().max() > 0)
        rec[label] = (v_err, g_err)
        lines.append(f"{label} {v_err:.3g} / {g_err:.3g}")
    ref = torch.rand(hw, hw, 3, generator=g)
    img = torch.clamp(ref * 0.8 + 0.07 + torch.randn(hw, hw, 3, generator=g) * 0.02, 0, 1)
    cc = [bg.color_correct(img.to(d), ref.to(d)).cpu().double() for d in ("cuda", "cpu")]
    cc64 = bg.color_correct(img.double().cuda(), ref.double().cuda()).cpu()
    e_card, e_cpu = (float((c - cc64).abs().max()) for c in cc)
    cc_err = float((cc[0] - cc[1]).abs().max())
    torch.cuda.synchronize()
    log(name, f"card vs CPU at {hw}^2 (value max abs / gradient max abs over peak): " + ", ".join(lines)
        + f" (limits {K8_VALUE_ABS} / {K8_GRAD_REL}); color_correct card vs CPU {cc_err:.3g}, against the float64 "
        f"fit card {e_card:.3g}, CPU {e_cpu:.3g} (limit {COLOR_CORRECT_FACTOR:g} x the CPU's + 1e-5)")
    if any(v > K8_VALUE_ABS or ge > K8_GRAD_REL for v, ge in rec.values()) or \
            e_card > COLOR_CORRECT_FACTOR * e_cpu + 1e-5:
        raise AssertionError(f"{name}: K8 or the bilateral grid disagrees between the card and the CPU")
    return dict(cases=rec, color_correct=cc_err, color_correct_vs_float64=(e_card, e_cpu))


def options_params(n, gen, num_images=SPLAT_CAMERAS):
    """The CPU splat parameters of ``splat_card_vs_cpu`` (anisotropic
    scales, random quaternions, SH rest coefficients, some gaussians near
    MCMC's dead opacity) with perturbed bilateral grids and small camera-opt
    tangents for ``num_images`` images."""
    from nerfstudio_torch.model_components.bilateral_grid import init_bilateral_grid

    _, state = build_splat("cpu", SPLAT_CHECK_HW, n, n)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    params["scales"] += torch.rand((n, 3), generator=gen) - 0.5
    params["quats"] = torch.randn((n, 4), generator=gen)
    params["features_rest"] = torch.randn(params["features_rest"].shape, generator=gen) * 0.1
    params["opacities"] = torch.rand((n, 1), generator=gen) * 6.0 - 3.0
    params["opacities"][: n // 20] = -6.0 - torch.rand((n // 20, 1), generator=gen)
    params["bilateral_grids"] = init_bilateral_grid(num_images, device="cpu") + torch.randn(
        (num_images, 12, 8, 16, 16), generator=gen) * 0.05
    params["camera_opt"] = torch.randn((num_images, 6), generator=gen) * 1e-3
    return params


def option_steps_card_vs_cpu(name):
    """One splat step at 128^2 on the card and on the CPU twins, from the
    same params and draws, for the MCMC config (its noise draw handed in;
    the means after the noise compared too) and for the bilateral grid,
    SO3xR3 camera optimisation and scale regularisation together (camera 1:
    the viewmat's gradient through K4, and the grids' and tangents'
    gradients compared with the gaussians'), at phase 18's limits."""
    gen = torch.Generator().manual_seed(SEED + 13)
    n = SPLAT_CHECK_GAUSS
    base = options_params(n, gen)
    bg = torch.rand((3,), generator=gen)
    noise = torch.randn((n, 3), generator=gen)
    configs = {"mcmc": dict(strategy="mcmc"),
               "bilateral grid + camera opt + scale reg": dict(use_bilateral_grid=True,
                                                               camera_optimizer_mode="SO3xR3",
                                                               use_scale_regularization=True)}
    recs = {}
    for label, options in configs.items():
        params = {k: v for k, v in base.items()
                  if k not in ("bilateral_grids", "camera_opt") or options.get("use_bilateral_grid")}
        runs = []
        zero_counts()
        for device in ("cuda", "cpu"):
            pipeline, state = build_splat(device, SPLAT_CHECK_HW, n, n, params=params, **options)
            c2w, K, w, h = pipeline.camera(pipeline.datamanager.train_cameras, 1)
            image = pipeline.datamanager.train_images[1]
            before = state.params["means"].detach().clone()
            metrics = pipeline.train_step(state, c2w, K, image, bg.to(device), w, h, 3, cam_idx=1,
                                          noise=noise.to(device), means_lr=1.6e-4)
            grads = {k: p.grad.detach().cpu().double() for k, p in state.params.items()}
            runs.append((float(metrics["loss"]), grads, (state.params["means"].detach() - before).cpu().double()))
        counts = read_counts()
        (l_card, g_card, mv_card), (l_cpu, g_cpu, mv_cpu) = runs
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        rel = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()) for k in g_cpu}
        # the means' move: Adam's ~lr steps where the gradient is strong, plus the noise
        strong = g_cpu["means"].abs() >= 1e-2 * g_cpu["means"].abs().max()
        move_rel = float((mv_card - mv_cpu).abs()[strong].max() / mv_cpu.abs().max())
        want = "project_gaussians_bwd_viewmat" if "camera_opt" in g_cpu else None
        recs[label] = dict(loss_rel=loss_rel, grad_rel=rel, move_rel=move_rel, launches=counts)
        log(name, f"{label}, {SPLAT_CHECK_HW}^2, {n} gaussians: loss {l_card:.6f} vs {l_cpu:.6f} (rel "
            f"{loss_rel:.2g}, limit {SPLAT_LOSS_RTOL}); gradients max |card - cpu| / peak "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + f" (limit {SPLAT_GRAD_REL}); the means' move "
            f"where their gradient is strong {move_rel:.3g} of the largest (limit 1e-2); card launches "
            f"{({k: v for k, v in counts.items() if v})}")
        if loss_rel > SPLAT_LOSS_RTOL or max(rel.values()) > SPLAT_GRAD_REL or move_rel > 1e-2:
            raise AssertionError(f"{name}: card and CPU steps disagree ({label})")
        if want and counts.get(want) != 1:
            raise AssertionError(f"{name}: the camera-opt step launched {want} {counts.get(want)} times")
    return recs


def full_image_card_vs_cpu(name):
    """A uint8 train and eval image holding every value 0..255, through
    ``FullImageDatamanager`` on the card and on the CPU: the card's float32
    images equal the CPU's (uint8 / 255) bit for bit."""
    from nerfstudio_torch.data.datamanagers import FullImageDatamanager

    img = torch.randint(0, 256, (1, SPLAT_CHECK_HW, SPLAT_CHECK_HW, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(SEED + 16))
    img.view(-1)[:256] = torch.arange(256, dtype=torch.uint8)
    cams = orbit_cameras(1, SPLAT_CHECK_HW, "cpu")
    out = []
    for device in ("cuda", "cpu"):
        dm = FullImageDatamanager(cams, img, cams, img, device=device)
        out.append((dm.next_train(0)[1].cpu(), dm.eval_image(0).cpu()))
    same = all(torch.equal(a, b) for a, b in zip(*out))
    quotient = torch.equal(out[1][0], img[0].to(torch.float32) / 255.0)
    log(name, f"FullImageDatamanager, a {SPLAT_CHECK_HW}^2 uint8 image with every value: the card's train and eval "
        f"images bit-equal to the CPU's {same}, the CPU's the quotient by 255 {quotient}")
    if not same or not quotient:
        raise AssertionError(f"{name}: the card's full images differ from the CPU's")
    return same


def refine_mcmc_card_vs_cpu(name):
    """One MCMC refine on the card and on the CPU from the same state
    (options_params' gaussians, 5% of them dead, random moments at count
    5) with the CPU's categorical draw handed to both: alive and the
    moments equal, every slot within 1e-6 of the largest value of its
    array (the relocation's pow, log and binomial sums)."""
    from nerfstudio_torch.models.splatfacto import SplatAux

    gen = torch.Generator().manual_seed(SEED + 14)
    n = SPLAT_CHECK_GAUSS
    params = {k: v for k, v in options_params(n, gen).items() if k not in ("bilateral_grids", "camera_opt")}
    moments = {k: (5, torch.rand(v.shape, generator=gen), torch.rand(v.shape, generator=gen))
               for k, v in params.items()}
    cfg = dict(strategy="mcmc", max_refine_new=1024)
    cpu_pipe, cpu_state = build_splat("cpu", SPLAT_CHECK_HW, n, n, params=params, **cfg)
    src = cpu_pipe.mcmc_draws(cpu_state, torch.Generator().manual_seed(SEED + 15))
    out = []
    for device in ("cuda", "cpu"):
        pipeline, state = build_splat(device, SPLAT_CHECK_HW, n, n, params=params, **cfg)
        state.optimizer.load_moments({k: (c, a.to(device), b.to(device)) for k, (c, a, b) in moments.items()})
        pipeline.refine_mcmc(state, src.to(device))
        out.append(({k: v.detach().cpu() for k, v in state.params.items()}, state.aux.alive.cpu(),
                    {k: [x.cpu() for x in state.optimizer._moments(k)] for k in params}))
    (p_card, a_card, m_card), (p_cpu, a_cpu, m_cpu) = out
    rel = {k: float((p_card[k] - p_cpu[k]).abs().max() / p_cpu[k].abs().max()) for k in p_cpu}
    moments_equal = all(torch.equal(a, b) for k in m_cpu for a, b in zip(m_card[k], m_cpu[k]))
    alive_equal = torch.equal(a_card, a_cpu)
    log(name, f"one MCMC refine, {n} gaussians ({int((torch.sigmoid(params['opacities'][:, 0]) < 0.005).sum())} "
        f"dead), the CPU's {src.numel()} draws ({len(torch.unique(src))} distinct sources): alive equal "
        f"{alive_equal}, moments equal {moments_equal}, params max |card - cpu| / peak "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + " (limit 1e-6)")
    if not alive_equal or not moments_equal or max(rel.values()) > 1e-6:
        raise AssertionError(f"{name}: the card's MCMC refine differs from the CPU's")
    return dict(rel=rel)


def options_run(name, scene, root, card):
    """splatfacto with the bilateral grid, SO3xR3 camera optimisation and
    scale regularisation on, OPTIONS_STEPS steps through ``scripts.gate``'s
    loop (not a gate: no JAX record exists): the logged loss falls, the
    camera-opt tangents stay finite, every step launches K4's backward with
    the viewmat gradient, and the eval colour-corrects every held-out view.
    Then every kernel of the path against its twin at the trained state,
    the viewmat's gradient at the step's own call included."""
    from nerfstudio_torch.pipelines import splat_pipeline
    from nerfstudio_torch.scripts import gate

    corrected = []
    color_correct = splat_pipeline.color_correct

    def counted(img, ref):
        corrected.append(tuple(img.shape))
        return color_correct(img, ref)

    t0 = time.perf_counter()
    zero_counts()
    splat_pipeline.color_correct = counted
    try:
        res, run = gate.run_gate("splatfacto", scene, os.path.join(root, "options"), OPTIONS_STEPS,
                                 overrides=list(OPTIONS_FLAGS))
    finally:
        splat_pipeline.color_correct = color_correct
    counts = read_counts()
    check_path(name, counts, SPLAT_PATH_KERNELS + ("project_gaussians_bwd_viewmat",))
    head, tail, fell = loss_fell(run["base_dir"])
    co = run["state"].params["camera_opt"].detach()
    n_eval = run["pipeline"].datamanager.eval_cameras.camera_to_worlds.shape[0]
    train = res["launches"]["train"]
    wall = time.perf_counter() - t0
    log(name, f"splatfacto {' '.join(OPTIONS_FLAGS)} on {res['scene']}, {OPTIONS_STEPS} steps: logged loss "
        f"{head:.4f} -> {tail:.4f} (first quarter's mean to the last's); camera_opt tangents finite "
        f"{bool(torch.isfinite(co).all())}, largest |translation| {float(co[:, :3].abs().max()):.3g}, |rotation| "
        f"{float(co[:, 3:].abs().max()):.3g}; eval over {n_eval} held-out views colour-corrected "
        f"({len(corrected)} calls): psnr {res['metrics']['psnr']:.2f}, ssim {res['metrics']['ssim']:.3f}; "
        f"{1e3 / res['steps_per_sec']:.2f} ms/step (host clock); launches per train step "
        f"{({k: v / OPTIONS_STEPS for k, v in train.items() if v})}; {wall:.1f} s wall on {card}")
    if not fell or not torch.isfinite(co).all() or len(corrected) < n_eval:
        raise AssertionError(f"{name}: loss {head} -> {tail}, camera_opt finite {bool(torch.isfinite(co).all())}, "
                             f"{len(corrected)} colour corrections for {n_eval} views")
    if train["project_gaussians_bwd_viewmat"] != OPTIONS_STEPS:
        raise AssertionError(f"{name}: {train['project_gaussians_bwd_viewmat']} viewmat backward launches in "
                             f"{OPTIONS_STEPS} steps")
    keep = {}
    errs = check_splat_step(name, run["one_step"], "the options run's trained state", keep)
    # K8 (plain PyTorch, no kernel of its own) at the step's own call: its
    # byte bound, the grid and coordinates read and the coefficients written
    from nerfstudio_torch.model_components import bilateral_grid as bg

    (grid, coords), _ = capture_kernel_calls({"k8": (bg, "grid_sample_3d")}, run["one_step"])["k8"][0]
    points = coords.numel() // coords.shape[-1]
    k8_bound = bound(nbytes(grid, coords) + points * grid.shape[0] * 4, points * grid.shape[0] * 16)
    log(name, f"K8 grid_sample_3d at one step's call: a {tuple(grid.shape)} grid at {points} pixels "
        f"({tuple(coords.shape)} coordinates), bound {k8_bound[0]:.5f} ms by {k8_bound[1]}")
    del run, grid, coords
    torch.cuda.empty_cache()
    return dict(res, gate_launches=res["launches"], launches=counts, wall_s=wall, max_abs_err=errs,
                loss=(head, tail), color_corrected=len(corrected), k8_bound_ms=k8_bound[0], k8_bound_by=k8_bound[1])


def options_and_methods(ph, card, scene, disk_root, disk):
    """Phases 47-52: K4's backward with the viewmat gradient against the
    float64 twin (the check inputs, 1M random slots, and after phase 50 a
    trained MCMC step's inputs), timed beside the default backward; K8 and
    the bilateral grid card vs CPU; one MCMC step, one step with the three
    options and one MCMC refine card vs CPU; the splatfacto-mcmc and
    splatfacto-big gate runs at 1,000,000 slots on ``scene``, cut in depth
    to CUT_GATE_STEPS;
    the three options' run through scripts.gate's loop. Adds the runs to
    ``disk``; returns the records of phases 47-49."""
    from nerfstudio_torch.ops.gsplat import projection as pj

    vgen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    pipeline, state = build_splat("cuda")
    x = splat_kernel_inputs(pipeline, state, vgen)
    del pipeline, state
    with torch.no_grad():
        ref = pj._project_kernel(x["means"], x["scales"], x["quats"], x["cam_args"])
    valid = ref[4] & x["alive"]
    chk = (x["means"], x["scales"], x["quats"], x["cam_args"],
           [torch.randn(t.shape, generator=vgen, device="cuda") * valid.view(-1, *([1] * (t.ndim - 1)))
            for t in ref[:3] + ref[5:]])
    del x, ref, valid
    big = k4_view_random(K4_VIEW_SLOTS, vgen)
    k4v_recs = [check_k4_viewmat(ph(47, "K4 bwd with the viewmat gradient"), "the check inputs", *chk),
                check_k4_viewmat(ph(47, "K4 bwd with the viewmat gradient"), f"{K4_VIEW_SLOTS:,} random slots",
                                 *big)]
    k4v_times = [time_k4_viewmat(ph(47, "K4 bwd timing"), *chk, "the check inputs"),
                 time_k4_viewmat(ph(47, "K4 bwd timing"), *big, f"{K4_VIEW_SLOTS:,} slots")]
    del chk, big
    torch.cuda.empty_cache()
    k8 = k8_card_vs_cpu(ph(48, "K8 and the bilateral grid, card vs CPU"), vgen)
    full_image_card_vs_cpu(ph(49, "full images, card vs CPU"))
    option_steps = option_steps_card_vs_cpu(ph(49, "option steps, card vs CPU"))
    mcmc_refine = refine_mcmc_card_vs_cpu(ph(49, "MCMC refine, card vs CPU"))
    keep = {}
    disk["gate_splatfacto-mcmc"] = gate_phase(ph(50, f"splatfacto-mcmc, {CUT_GATE_STEPS} steps"), "splatfacto-mcmc",
                                              scene, disk_root, card, SPLAT_PATH_KERNELS, steps=CUT_GATE_STEPS,
                                              keep=keep)
    m, s_, q, cam, cots = keep.pop("k4_bwd")
    label = "one trained splatfacto-mcmc step's inputs"
    k4v_recs.append(check_k4_viewmat(ph(47, "K4 bwd with the viewmat gradient"), label, m, s_, q, cam, cots))
    k4v_times.append(time_k4_viewmat(ph(47, "K4 bwd timing"), m, s_, q, cam, cots, label))
    del m, s_, q, cam, cots
    disk["gate_splatfacto-big"] = gate_phase(ph(51, f"splatfacto-big, {CUT_GATE_STEPS} steps"), "splatfacto-big",
                                             scene, disk_root, card, SPLAT_PATH_KERNELS, steps=CUT_GATE_STEPS)
    disk["options"] = options_run(ph(52, "splatfacto with the three options"), scene, disk_root, card)
    return dict(k4v_recs=k4v_recs, k4v_times=k4v_times, k8=k8, option_steps=option_steps, mcmc_refine=mcmc_refine)


# --------------------------------------------------------------------------
# nerfacto-big and nerfacto-huge at full width; plain neus


# nerfacto-big's gate run (phase 55), cut in depth from its 3000 steps to
# fit phases 61-67 (the full gate: PERF.md §6)
BIG_CUT_STEPS = 1000
NEUS_PLAIN_STEPS = 300  # plain neus on blender, cut in depth from its gate's 12000 (full run: PERF.md §6)
NEUS_PLAIN_EVAL_HW = 32  # one eval chunk of the method config's 1024 rays
# Card vs CPU, plain neus's eval chunk: the SDF field is float32 on both
# sides, but the sampler's four SDF passes sum in another order, which moves
# the upsampled bins by float32 ulps; the eval parity test against JAX
# (tests/test_torch_neus_plain.py) holds the same render at this limit. A
# normal counts by its ray's accumulation: a ray that barely meets the
# surface has a normal of no weight.
NEUS_PLAIN_EVAL_ATOL = 1e-3


def touched_line_bytes(pos, table, kw, exact):
    """Bytes of the distinct 128-byte lines of ``table`` that K1 (the
    8-corner block it picks per level) or K3 (``exact``: each of the 8
    corners' blocks) reads at ``pos``, over every level: each line read
    once from HBM, at most the table's own size. A table beyond the 50 MB
    L2 cannot be kept there between calls, so every line a call touches
    comes from HBM at least once; within L2 this is the least, too."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, _ = table.shape
    T = kw["hash_table_size"]
    F = 128 * S // T
    bpr = 16 // F  # blocks per 128-float row
    total = 0
    with torch.no_grad():
        for res in hg.compute_level_resolutions(L, kw["min_res"], kw["max_res"]):
            res = int(res)
            if exact:
                bs, dense_b = hg._block_level_layout(res, T)
                (ix0, _), (iy0, _), (iz0, _) = hg._base_cells(pos, res)
                blocks = [hg._block_index((ix0 + ((c >> 2) & 1)) >> 1, (iy0 + ((c >> 1) & 1)) >> 1,
                                          (iz0 + (c & 1)) >> 1, bs, dense_b, T // 8) for c in range(8)]
                blk = torch.cat(blocks)
            else:
                rows, slot, _ = hg._level_blocks(pos, res, T, bpr)
                blk = rows * bpr + slot
            # a block of 8F floats (32F bytes) starts at a multiple of 32F
            # bytes: it lies within one 128-byte line (32 floats) at F <= 4
            lanes = (blk // bpr) * 128 + (blk % bpr) * (8 * F)
            total += int(torch.unique(lanes // 32).numel()) * 128
    return total


def timed_hash_kernels(name, run, label, card):
    """K1's forward and backward at every call of one more step of
    ``run["one_step"]``, and K3 and the proposal's K1 at the first eval
    chunk of the model's own ``eval_num_rays_per_chunk`` (the first eval
    view): every design against its twin (``check_block_designs``;
    ``check_bwd_designs`` against the float64 twin, without the "scatter
    alone" yardstick), then timed in turns (CUDA events), by the profiler's
    device time and over 50 calls back to back, beside the twin's time and
    two bounds: the function's (``bound``: the whole table read) and one
    that reads once each 128-byte table line the samples touch
    (``touched_line_bytes``; the backward's dense table gradient is still
    written whole). Returns ({kernel: max abs err}, [records])."""
    from nerfstudio_torch.ops import hash_grid as hg

    calls = capture_kernel_calls({"fwd": (hg, "_block_kernel"), "bwd": (hg, "_block_bwd_kernel")}, run["one_step"])
    pipeline, state = run["pipeline"], run["state"]
    chunk = pipeline.model.config.eval_num_rays_per_chunk
    cam_idx = pipeline.datamanager.eval_image(0)[0]
    ev = capture_kernel_calls({"fwd": (hg, "_block_kernel")},
                              lambda: pipeline.render_eval_camera(state, cam_idx, chunk))["fwd"]
    k3 = [i for i, (_, kw) in enumerate(ev) if kw["exact"]]
    if not calls["fwd"] or not calls["bwd"] or not k3:
        raise AssertionError(f"{name}: one step called K1 {len(calls['fwd'])} and its backward {len(calls['bwd'])} "
                             f"times, an eval view K3 {len(k3)} times")
    errs = {"hash_encode_block": 0.0, "hash_encode_block_exact": 0.0, "hash_encode_block_bwd": 0.0}
    recs = []
    fwd_sets = [("a trained step", c) for c in calls["fwd"]] + [(f"the first {chunk}-ray eval chunk", c)
                                                                 for c in ev[:k3[0] + 1]]
    for where, ((pos, table), kw) in fwd_sets:
        kw = dict(kw)
        exact = kw.pop("exact")
        L, S, _ = table.shape
        F = 128 * S // kw["hash_table_size"]
        n = pos.shape[0]
        kernel = "K3" if exact else "K1 fwd"
        what = (f"{label}, {where}, {kernel}: N={n} L={L} F={F} T=2^{kw['hash_table_size'].bit_length() - 1} "
                f"max_res={kw['max_res']}, table {nbytes(table) / 2**20:.0f} MiB")
        design_errs, timing, fn_bound = check_block_designs(name, exact, pos, table, kw, what)
        key = "hash_encode_block_exact" if exact else "hash_encode_block"
        errs[key] = max(errs[key], *design_errs.values())
        events, dev, bat = time_block_designs(timing)
        with torch.no_grad():
            twin_ms = median_ms(timing["twin"], runs=3, warmup=1)
        lines = touched_line_bytes(pos, table, kw, exact)
        line_bound = bound(nbytes(pos) + n * L * F * 4 + lines, hash_fwd_ops(n, L, F))
        recs.append(dict(kernel=kernel, inputs=where, n=n, levels=L, features=F, hash_table_size=kw["hash_table_size"],
                         max_res=kw["max_res"], table_bytes=nbytes(table), touched_bytes=lines,
                         design=hg._pick_design(F), plain_ms=twin_ms, bound_ms=fn_bound[0], bound_by=fn_bound[1],
                         line_bound_ms=line_bound[0], line_bound_by=line_bound[1],
                         designs={d: dict(ms=events[d][0], ms_runs=events[d][1], device_ms=dev[d], batch_ms=bat[d],
                                          max_abs_err=design_errs[d]) for d in hg.DESIGNS}))
    for (pos, table, g, scales), kw in calls["bwd"]:
        kw = dict(kw)
        needs = {k: kw.pop(k) for k in ("need_positions", "need_table")}
        L, S, _ = table.shape
        F = 128 * S // kw["hash_table_size"]
        n = pos.shape[0]
        rec = check_bwd_designs(f"{name}, {label}, a trained step", "K1", pos, table, g, kw, scales, yardstick=False,
                                **needs)
        errs["hash_encode_block_bwd"] = max(errs["hash_encode_block_bwd"],
                                            *(r["max_abs_err"] for r in rec["designs"].values()))
        lines = touched_line_bytes(pos, table, kw, False) if needs["need_positions"] else 0
        moved = (nbytes(pos, g) + lines + (nbytes(table) if needs["need_table"] else 0)
                 + (nbytes(pos) if needs["need_positions"] else 0))
        line_bound = bound(moved, hash_bwd_ops(n, L, F, needs["need_positions"]))
        recs.append(dict(kernel="K1 bwd", inputs="a trained step", n=n, levels=L, features=F,
                         hash_table_size=kw["hash_table_size"], max_res=kw["max_res"], table_bytes=nbytes(table),
                         touched_bytes=lines, scales=rec["scales"], **needs, design=hg._pick_design(F),
                         bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], line_bound_ms=line_bound[0],
                         line_bound_by=line_bound[1], designs=rec["designs"]))
    for r in recs:
        d = r["designs"][r["design"]]
        log(name, f"{r['kernel']} at {label}, {r['inputs']} (N={r['n']} L={r['levels']} F={r['features']} "
            f"T={r['hash_table_size']}, table {r['table_bytes'] / 2**20:.0f} MiB, touched lines "
            f"{r['touched_bytes'] / 2**20:.1f} MiB) on {card}: {r['design']} {d['ms']:.4f} ms "
            f"{[round(m, 4) for m in d['ms_runs']]} (events), device {d['device_ms']:.4f}, back to back "
            f"{d['batch_ms']:.4f}; bound {r['line_bound_ms']:.4f} ms by {r['line_bound_by']} (the touched lines; "
            f"the whole table's {r['bound_ms']:.4f})"
            + (f"; twin {r['plain_ms']:.3f} ms" if "plain_ms" in r else "") + "; the other designs: "
            + ", ".join(f"{k} {v['ms']:.4f} / {v['device_ms']:.4f} / {v['batch_ms']:.4f}"
                        for k, v in r["designs"].items() if k != r["design"]))
    del calls, ev
    return errs, recs


def neus_plain_card_vs_cpu(name):
    """One plain-neus training step at the shipped width (the method config's
    model and optimizer) on the card and on the CPU twins, from the card's
    initial weights and the same draws (pixels, the uniform round's jitter
    and the four upsampling rounds'), on bench.py's scene; then one eval
    chunk (a NEUS_PLAIN_EVAL_HW^2 frame, one 1024-ray chunk) from the
    stepped weights. Returns (card metrics, CPU metrics, loss rel, {param:
    grad rel}, {output: max abs gap})."""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.models.neus import NeuSModel
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws, TrainState, VanillaPipeline

    config = get_method("neus")
    cfg = config.model
    gen = torch.Generator().manual_seed(SEED + 5)
    draws = StepDraws(
        torch.stack([torch.randint(0, n, (NEUS_CHECK_RAYS,), generator=gen)
                     for n in (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW)], dim=-1),
        SamplerUniforms(None, tuple(torch.rand((NEUS_CHECK_RAYS, 1), generator=gen)
                                    for _ in range(cfg.num_upsample_steps + 1))),
    )
    images = np.random.default_rng(SEED).integers(0, 255, (TRAIN_IMAGES, TRAIN_HW, TRAIN_HW, 3)).astype(np.uint8)
    runs, weights = [], None
    for device in ("cuda", "cpu"):
        model = cfg.setup(num_train_data=TRAIN_IMAGES, device=device).train()
        model.reset_parameters(torch.Generator(device=device).manual_seed(SEED))
        if weights is None:
            weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        dm = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=NEUS_CHECK_RAYS),
                                    orbit_cameras(TRAIN_IMAGES, TRAIN_HW, device), torch.from_numpy(images), device)
        pipeline = VanillaPipeline(dm, model)
        state = TrainState(PerGroupAdam(config.optimizers, model))
        dev_draws = StepDraws(draws.pixels.to(device),
                              SamplerUniforms(None, tuple(u.to(device) for u in draws.sampler.rounds)))
        metrics = pipeline.train_step(state, draws=dev_draws, **NeuSModel.step_kwargs(NEUS_EARLY, cfg))
        grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
        model.eval()
        frame = render_camera(model, None, orbit_cameras(NUM_CAMERAS, NEUS_PLAIN_EVAL_HW, device), 0,
                              NEUS_PLAIN_EVAL_HW**2)
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, {k: v.cpu() for k, v in frame.items()}))
        del pipeline, state, model
    (m_card, g_card, f_card), (m_cpu, g_cpu, f_cpu) = runs
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    grad_rel = {n: float((g_card[n] - ref).abs().max() / ref.abs().max()) for n, ref in g_cpu.items()
                if ref.abs().max() > 0}
    gaps = {k: float((f_card[k] - f_cpu[k]).abs().max()) for k in ("rgb", "accumulation")}
    gaps["depth (relative)"] = float(((f_card["depth"] - f_cpu["depth"]).abs() / f_cpu["depth"].abs().clamp_min(1.0))
                                     .max())
    gaps["normals x accumulation"] = float(((f_card["normals"] - f_cpu["normals"]).abs()
                                            * f_cpu["accumulation"]).max())
    for k, c in (("rgb", 3), ("accumulation", 1), ("depth", 1), ("normals", 3)):
        if tuple(f_card[k].shape) != (NEUS_PLAIN_EVAL_HW, NEUS_PLAIN_EVAL_HW, c) or not torch.isfinite(f_card[k]).all():
            raise AssertionError(f"{name}: eval {k}: shape {tuple(f_card[k].shape)} or non-finite values")
    worst = max(grad_rel, key=grad_rel.get)
    log(name, f"{NEUS_CHECK_RAYS} rays of {TRAIN_HW}^2 images, the shipped width ({cfg.num_samples} uniform + "
        f"{cfg.num_upsample_steps} x {cfg.num_samples_importance // cfg.num_upsample_steps} upsampled samples per "
        f"ray), the draws handed in: loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit "
        f"{NEUS_LOSS_RTOL}); gradients max |card - cpu| / peak {grad_rel[worst]:.3g} at {worst} (limit "
        f"{NEUS_GRAD_REL}); one {NEUS_PLAIN_EVAL_HW ** 2}-ray eval chunk, max |card - cpu|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()) + f" (limit {NEUS_PLAIN_EVAL_ATOL})")
    if loss_rel > NEUS_LOSS_RTOL or grad_rel[worst] > NEUS_GRAD_REL or max(gaps.values()) > NEUS_PLAIN_EVAL_ATOL:
        raise AssertionError(f"{name}: card and CPU plain-neus steps or eval chunks disagree")
    return dict(loss=(m_card["loss"], m_cpu["loss"]), loss_rel=loss_rel, grad_rel=grad_rel[worst], eval=gaps)


def big_methods_and_neus(ph, card, scene, disk_root, disk):
    """Phases 53-57: one nerfacto-huge step at 1024 rays card vs CPU; the
    nerfacto-huge (1500 steps) and nerfacto-big (BIG_CUT_STEPS of 3000) gates on ``scene`` at
    full width, each followed by K1's forward and backward and K3 at its
    trained state in every design against the twins, timed, and by its
    device's idle share and the hash grid's share of the busy time; one
    plain-neus step and eval chunk card vs CPU; plain neus on the
    ``blender`` scene for NEUS_PLAIN_STEPS steps (cut in depth: the loss
    must fall), its idle share. Adds the runs to ``disk``; returns the
    card-vs-CPU records."""
    name = ph(53, "nerfacto-huge step, card vs cpu")
    m_card, m_cpu, loss_rel, grad_rel, table_rel = card_vs_cpu_step(method="nerfacto-huge")
    log(name, f"{CHECK_RAYS} rays, the shipped width (field L16 F4 T=2^21, 256-wide MLPs; proposal L7), flat "
        f"tables: loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {STEP_LOSS_RTOL}); "
        f"non-table gradients max |card - cpu| / peak {grad_rel:.3g} (limit {STEP_GRAD_REL}); table gradients per "
        f"level and feature {table_rel:.3g} of the peak (limit {STEP_TABLE_SUM_REL})")
    if loss_rel > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL or table_rel > STEP_TABLE_SUM_REL:
        raise AssertionError(f"{name}: card and CPU nerfacto-huge steps disagree")
    huge_step = dict(loss_rel=loss_rel, grad_rel=grad_rel, table_rel=table_rel)
    torch.cuda.empty_cache()
    for i, method, steps in ((54, "nerfacto-huge", None), (55, "nerfacto-big", BIG_CUT_STEPS)):
        name = ph(i, f"gate {method}" + (f", {steps} steps" if steps else ""))
        rec = disk[f"gate_{method}"] = gate_phase(name, method, scene, disk_root, card, NERFACTO_KERNELS, steps=steps,
                                                  timed=True)
        idle = rec["idle"]
        if idle is not None:
            hash_ms = idle["classes"].get("hash-grid kernels", 0.0)
            rec["hash_share"] = hash_ms / idle["busy_ms"]
            log(name, f"{method}: {rec['train_rays_per_sec']:,.0f} rays/s over the gate (host clock); the hash-grid "
                f"kernels {hash_ms:.3f} ms of {idle['busy_ms']:.2f} ms device-busy per step "
                f"({rec['hash_share']:.1%}), idle {idle['idle']:.1%} on {card}")
    neus_step = neus_plain_card_vs_cpu(ph(56, "plain neus step and eval chunk, card vs cpu"))
    blender = make_scene(ph(57, "scene"), disk_root, "blender")
    disk["neus"] = gate_phase(ph(57, f"neus on blender, {NEUS_PLAIN_STEPS} steps"), "neus", blender, disk_root, card,
                              (), steps=NEUS_PLAIN_STEPS)
    return dict(huge_step=huge_step, neus_step=neus_step)


def trained_step_card_vs_cpu(run):
    """One training step at the trained state of a from-disk run on the
    card and on the CPU twins: copies of the trained model with every hash
    table set flat per level and feature (phase 11's device against the
    stochastic rounding, which hashes float bits) and of its occupancy
    grid; the scene's train images, depths and labels; the same CHECK_RAYS
    pixels and sampler jitter, drawn on the host; the step kwargs of the
    run's next step; a fresh optimizer each (the family's groups, which
    move no gradient). Returns (card metrics, CPU
    metrics, loss rel, grads rel, tables rel, {term: rel})."""
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam, nerfacto_optimizers
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws, TrainState, VanillaPipeline

    pipeline, state = run["pipeline"], run["state"]
    dm, trained = pipeline.datamanager, pipeline.model
    step = int(state.step)
    kwargs = type(trained).step_kwargs(step, trained.config)
    gen = torch.Generator().manual_seed(SEED + 7)
    n, h, w = dm.train_images.shape[:3]
    draws = StepDraws(
        torch.stack([torch.randint(0, m, (CHECK_RAYS,), generator=gen) for m in (n, h, w)], dim=-1),
        SamplerUniforms(torch.rand((CHECK_RAYS, 1), generator=gen),
                        (torch.rand((CHECK_RAYS, 1), generator=gen), torch.rand((CHECK_RAYS, 1), generator=gen))))
    stacks = {k: None if getattr(dm, f"train_{k}") is None else getattr(dm, f"train_{k}").cpu()
              for k in ("depths", "semantics")}
    weights, runs = None, []
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(trained).to(device).train()
        if weights is None:
            flatten_tables(model, torch.Generator().manual_seed(SEED + 2))
            weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        data = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=CHECK_RAYS),
                                      dm.train_cameras.to(device), dm.train_images.cpu(), device, **stacks)
        twin = VanillaPipeline(data, model)
        st = TrainState(PerGroupAdam(nerfacto_optimizers(), model), aux=state.aux.to(device))
        dev_draws = StepDraws(draws.pixels.to(device), SamplerUniforms(
            draws.sampler.probes.to(device), tuple(u.to(device) for u in draws.sampler.rounds)))
        metrics = twin.train_step(st, draws=dev_draws, **kwargs)
        grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters() if p.grad is not None}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, model))
        del twin, st, data
    (m_card, g_card, model), (m_cpu, g_cpu, _) = runs
    terms = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
             for k in m_cpu if k.endswith("_loss") and m_cpu[k] != 0}
    return (m_card, m_cpu) + step_rel(m_card, g_card, m_cpu, g_cpu, model) + (terms,)


def family_after(name, method, term, card):
    """The checks ``nerfacto_family`` runs at each trained state: the rgb
    loss and ``term`` fell over the run, one step card vs CPU within phase
    11's limits (every loss term too), the hash grid's share of the
    profiled steps' busy time."""

    def after(run):
        falls = {k: loss_fell(run["base_dir"], k) for k in ("rgb_loss",) + ((term,) if term else ())}
        for k, (head, tail, fell) in falls.items():
            if not fell:
                raise AssertionError(f"{name}: {method}'s {k} did not fall: {head} -> {tail}")
        m_card, m_cpu, loss_rel, grad_rel, table_rel, terms = trained_step_card_vs_cpu(run)
        log(name, f"{method}: " + ", ".join(f"{k} {h:.5f} -> {t:.5f}" for k, (h, t, _) in falls.items())
            + f" (first quarter's mean to the last's); one step at the trained state ({CHECK_RAYS} rays, flat "
            f"tables, the next step's kwargs) card vs CPU: loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel "
            f"{loss_rel:.2g}, limit {STEP_LOSS_RTOL}), terms " + ", ".join(f"{k} {v:.2g}" for k, v in terms.items())
            + f"; non-table gradients {grad_rel:.3g} of the peak (limit {STEP_GRAD_REL}); tables per level and "
            f"feature {table_rel:.3g} (limit {STEP_TABLE_SUM_REL}) on {card}")
        if (loss_rel > STEP_LOSS_RTOL or max(terms.values()) > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL
                or table_rel > STEP_TABLE_SUM_REL):
            raise AssertionError(f"{name}: card and CPU {method} steps disagree")
        return dict(falls={k: v[:2] for k, v in falls.items()}, loss_rel=loss_rel, terms=terms, grad_rel=grad_rel,
                    table_rel=table_rel)

    return after


def nerfacto_family(ph, card, scene, disk_root, disk, jobs):
    """Phases 58-60: depth-nerfacto, semantic-nerfw and phototourism through
    ``scripts.gate``'s loop for FAMILY_STEPS steps each, on their gates'
    scenes (the semantic and appearance ones from ``jobs``, {scene:
    ``start_scene`` job}), each checked
    at its trained state (``gate_phase`` and ``family_after``; FAMILY_TIMED's
    kernels also timed, ``timed_hash_kernels``); the hash grid's share of
    the profiled steps' busy time and the launches per step. Adds the runs
    to ``disk``."""
    for i, (method, scene_name, term) in enumerate(FAMILY):
        name = ph(58 + i, f"{method}, {FAMILY_STEPS} steps")
        if scene_name in jobs:
            finish_scene(ph(58 + i, "scene"), jobs.pop(scene_name))
        rec = disk[f"gate_{method}"] = gate_phase(name, method, scene, disk_root, card, NERFACTO_KERNELS,
                                                  steps=FAMILY_STEPS, timed=method == FAMILY_TIMED,
                                                  after=family_after(name, method, term, card))
        if rec["scene"] != scene_name:
            raise AssertionError(f"{name}: the gate ran {method} on {rec['scene']}, not {scene_name}")
        per_step = {k: v / rec["steps"] for k, v in rec["gate_launches"]["train"].items() if v}
        idle = rec["idle"]
        if idle is not None:
            rec["hash_share"] = idle["classes"].get("hash-grid kernels", 0.0) / idle["busy_ms"]
        log(name, f"{method}: launches per train step {per_step}; the hash-grid kernels "
            + ("not measured" if idle is None else
               f"{idle['classes'].get('hash-grid kernels', 0.0):.3f} ms of {idle['busy_ms']:.2f} ms device-busy per "
               f"profiled step ({rec['hash_share']:.1%}), idle {idle['idle']:.1%}") + f" on {card}")


# -- the Blender-protocol methods (phases 61-63) ---------------------------------

# tensorf, vanilla-nerf and mipnerf on the blender scene of phase 57 through
# scripts.gate's loop at their shipped configs, cut in depth: tensorf past
# its first grid upsample (step 2000, R 128 -> 152, the optimizer
# re-initialised), the NeRFs to 300 of their 8000 steps (the full gates:
# their own chip call, PERF.md)
BLENDER_RUNS = (("tensorf", 2200), ("vanilla-nerf", 300), ("mipnerf", 300))
BLENDER_CHECK_RAYS = 256  # the card-vs-CPU step: the CPU runs the 8x256 bfloat16 NeRF MLPs
BLENDER_EVAL_RAYS = 1024  # the card-vs-CPU eval chunk: rays spread evenly over the first test view


def segment_fell(losses):
    """(first quarter's mean, last quarter's, finite and falling) of a run
    of logged losses."""
    q = max(len(losses) // 4, 1)
    head, tail = statistics.fmean(losses[:q]), statistics.fmean(losses[-q:])
    return head, tail, all(map(math.isfinite, losses)) and tail < head


def logged(run_dir, key="loss"):
    """[(step, value)] of a logged train term."""
    with open(os.path.join(run_dir, "scalars.jsonl"), encoding="utf-8") as f:
        return [(r["step"], r[key]) for r in map(json.loads, f) if r["prefix"] == "train"]


def k8_step(name, run, card):
    """K8 (``grid_sample_1d/2d``, plain PyTorch) at one tensorf step's own
    calls: each call's grid and coordinates captured (the coarse pass's
    under no_grad, the fine pass's with the planes' gradient), then replayed
    alone, forward and, for the fine calls, the backward into the grids,
    with the step's cotangent shapes: CUDA events around one replay
    (median), its profiler device time and kernel launches, beside the
    bound (each grid, coordinate and output byte once; the backward reads
    the cotangents and writes the grids' gradients)."""
    from nerfstudio_torch.field_components import encodings as enc

    calls = []
    originals = {f: getattr(enc, f) for f in ("grid_sample_1d", "grid_sample_2d")}

    def capture(f):
        def call(grid, coords):
            calls.append((f, grid.detach().clone(), coords.detach().clone(), torch.is_grad_enabled()
                          and grid.requires_grad))
            return originals[f](grid, coords)
        return call

    for f in originals:
        setattr(enc, f, capture(f))
    try:
        run["one_step"]()
    finally:
        for f, fn in originals.items():
            setattr(enc, f, fn)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    leaves = [(f, g.requires_grad_(True) if want else g, c, want) for f, g, c, want in calls]
    trained = [x for x in leaves if x[3]]
    points = lambda f, c: c.numel() // (2 if f.endswith("2d") else 1)  # noqa: E731
    taps = lambda f: 4 if f.endswith("2d") else 2  # noqa: E731
    lead = lambda f, c: tuple(c.shape[:-1] if f.endswith("2d") else c.shape)  # noqa: E731
    cots = [torch.rand(lead(f, c) + (g.shape[0],), generator=gen, device="cuda") for f, g, c, _ in trained]

    def replay():
        with torch.no_grad():
            for f, g, c, want in leaves:
                if not want:
                    originals[f](g, c)
        for _, g, _, _ in trained:
            g.grad = None
        torch.autograd.backward([originals[f](g, c) for f, g, c, _ in trained], cots)

    ms = median_ms(replay, runs=10)
    dev = device_ms(replay)
    launches = sum(len(v) for v in _kernel_records(replay, 1).values())
    # forward: each grid and coordinate read once, each output written once;
    # backward: each cotangent and coordinate read, each grid's gradient
    # written; a multiply-add per tap and channel each way
    moved = sum(nbytes(g, c) + points(f, c) * g.shape[0] * 4 for f, g, c, _ in leaves)
    moved += sum(nbytes(cot, c, g) for (f, g, c, _), cot in zip(trained, cots))
    ops = sum(2 * taps(f) * points(f, c) * g.shape[0] for f, g, c, _ in leaves + trained)
    bnd = bound(moved, ops)
    shapes = sorted({(f, tuple(g.shape), points(f, c), w) for f, g, c, w in leaves})
    log(name, f"K8 at one trained step's own calls: {len(calls)} calls ({len(trained)} with the planes' gradient; "
        f"shapes {shapes}), replayed alone: {ms:.4f} ms events, {dev:.4f} ms device (torch.profiler), "
        f"{launches} kernel launches; bound {bnd[0]:.4f} ms ({bnd[1]}) on {card}")
    return dict(calls=len(calls), grad_calls=len(trained), ms=ms, device_ms=dev, launches=launches,
                bound_ms=bnd[0], bound_by=bnd[1])


def blender_step_card_vs_cpu(run, method):
    """One training step at the trained state on the card and on the CPU:
    copies of the trained model with every MLP and head computing its
    products in float32 (the shipped bfloat16 rounds the 8x256 NeRF nets'
    products in another order on each side, which moves vanilla-nerf's
    first fine layer's gradient by ~6% of its peak on the H100), the run's train
    images and cameras, the same BLENDER_CHECK_RAYS pixels and sampler
    jitter drawn on the host, a fresh optimizer of the method's groups
    each. Returns (card metrics, CPU metrics, loss rel, {term: rel},
    {param: grad max |card - cpu| / peak})."""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam
    from nerfstudio_torch.field_components.field_heads import FieldHead
    from nerfstudio_torch.field_components.mlp import MLP
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws, TrainState, VanillaPipeline

    pipeline = run["pipeline"]
    dm, trained = pipeline.datamanager, pipeline.model
    cfg = trained.config
    widths = ((1, cfg.num_samples + 1) if method == "tensorf"
              else (cfg.num_coarse_samples + 1, cfg.num_importance_samples + 1))
    gen = torch.Generator().manual_seed(SEED + 8)
    n, h, w = dm.train_images.shape[:3]
    pixels = torch.stack([torch.randint(0, m, (BLENDER_CHECK_RAYS,), generator=gen) for m in (n, h, w)], dim=-1)
    jitter = tuple(torch.rand((BLENDER_CHECK_RAYS, k), generator=gen) for k in widths)
    runs = []
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(trained).to(device).train()
        for m in model.modules():
            if isinstance(m, (MLP, FieldHead)):
                m.dtype = torch.float32
        data = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=BLENDER_CHECK_RAYS),
                                      dm.train_cameras.to(device), dm.train_images.cpu(), device)
        twin = VanillaPipeline(data, model)
        st = TrainState(PerGroupAdam(get_method(method).optimizers, model))
        metrics = twin.train_step(st, draws=StepDraws(pixels.to(device),
                                                      SamplerUniforms(None, tuple(u.to(device) for u in jitter))))
        grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters() if p.grad is not None}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads))
        del twin, st, data, model
    (m_card, g_card), (m_cpu, g_cpu) = runs
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    terms = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu if "loss" in k or "reg" in k}
    grad_rel = {k: float((g_card[k] - ref).abs().max() / ref.abs().max()) for k, ref in g_cpu.items()
                if ref.abs().max() > 0}
    return m_card, m_cpu, loss_rel, terms, grad_rel


def blender_eval_card_vs_cpu(run):
    """One eval chunk (BLENDER_EVAL_RAYS rays spread evenly over the first
    test view, object and background) through the pipeline's eval path on
    the card, which renders under the background override (the parser's
    white), and through a CPU copy of the model under the same override.
    Returns ({output: mean |card - cpu|}, {output: max}, the override, the
    card's mean rgb where the accumulation is below 1e-3: white expected)."""
    from nerfstudio_torch.model_components import renderers

    pipeline, state = run["pipeline"], run["state"]
    cams = pipeline.datamanager.eval_cameras
    cam_idx = pipeline.datamanager.eval_image(0)[0]
    rb = cams.generate_rays(camera_indices=cam_idx).flatten()
    stride = max(rb.shape[0] // BLENDER_EVAL_RAYS, 1)
    rb = rb.map(lambda x: x[::stride][:BLENDER_EVAL_RAYS])
    color = pipeline._eval_background()
    card = pipeline.eval_rays(state, rb.map(lambda x: x.to("cuda")))
    model = copy.deepcopy(pipeline.model).to("cpu").eval()
    with torch.no_grad(), renderers.background_color_override_context(color.cpu()):
        cpu = model(rb.map(lambda x: x.cpu()))
    keys = ("rgb", "accumulation", "depth")
    mean = {k: float((card[k].cpu() - cpu[k]).abs().mean()) for k in keys}
    peak = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in keys}
    empty = card["accumulation"][..., 0] < 1e-3
    bg = float(card["rgb"][empty].mean()) if bool(empty.any()) else float("nan")
    del model
    return mean, peak, color.tolist(), bg


def blender_after(name, method, card):
    """The checks at each trained state after the gate loop: the losses fell
    (tensorf's before its upsample and again after it, with the grids at
    152 and the optimizer's count restarted at the upsample; both passes'
    rgb losses of the NeRFs); one step card vs CPU (loss and every term
    within STEP_LOSS_RTOL, every gradient within STEP_GRAD_REL of its peak);
    one eval chunk under the override card vs CPU (rgb and accumulation
    within CARD_VS_CPU_MEAN_ABS mean abs); tensorf's K8 at its step's own
    calls (``k8_step``)."""

    def after(run):
        base = run["base_dir"]
        rec = {}
        if method == "tensorf":
            steps = logged(base)
            model, state = run["pipeline"].model, run["state"]
            first, want = model.config.upsampling_iters[0], type(model).upsample_resolutions(model.config)[0]
            res = (model.field.density_encoding.resolution, model.field.color_encoding.resolution)
            count, step = state.optimizer.count, int(state.step)
            pre = segment_fell([v for s, v in steps if s < first])
            post = segment_fell([v for s, v in steps if s >= first])
            jump = ([v for s, v in steps if s < first][-1], [v for s, v in steps if s >= first][0])
            rec.update(before=pre[:2], after=post[:2], jump=jump, resolution=res, count=count, step=step)
            log(name, f"tensorf: loss {pre[0]:.5f} -> {pre[1]:.5f} over steps 0-{first - 1}, {jump[0]:.5f} at the "
                f"last log before the upsample, {jump[1]:.5f} at the first after, then {post[0]:.5f} -> "
                f"{post[1]:.5f} (first quarter's mean to the last's); grids at {res} (want {want}), the "
                f"optimizer's count {count} at step {step}")
            if not (pre[2] and post[2]) or res != (want, want) or count != step - first:
                raise AssertionError(f"{name}: tensorf's loss, upsample or optimizer reset is wrong: {rec}")
        else:
            falls = {k: segment_fell([v for _, v in logged(base, k)]) for k in ("rgb_loss_coarse", "rgb_loss_fine")}
            log(name, f"{method}: " + ", ".join(f"{k} {h:.5f} -> {t:.5f}" for k, (h, t, _) in falls.items())
                + " (first quarter's mean to the last's)")
            if not all(f for _, _, f in falls.values()):
                raise AssertionError(f"{name}: {method}'s losses did not fall: {falls}")
            rec["falls"] = {k: v[:2] for k, v in falls.items()}
        m_card, m_cpu, loss_rel, terms, grad_rel = blender_step_card_vs_cpu(run, method)
        worst = max(grad_rel, key=grad_rel.get)
        mean, peak, color, bg = blender_eval_card_vs_cpu(run)
        log(name, f"{method}: one step at the trained state ({BLENDER_CHECK_RAYS} rays, the draws handed in, the "
            f"MLPs' products in float32) card "
            f"vs CPU: loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {STEP_LOSS_RTOL}), "
            "terms " + ", ".join(f"{k} {v:.2g}" for k, v in terms.items()) + f"; gradients max |card - cpu| / "
            f"peak {grad_rel[worst]:.3g} at {worst} (limit {STEP_GRAD_REL}); one {BLENDER_EVAL_RAYS}-ray eval "
            f"chunk under the override {color}, mean |card - cpu| " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                                                mean.items())
            + " (max " + ", ".join(f"{k} {v:.3g}" for k, v in peak.items()) + f"; limit {CARD_VS_CPU_MEAN_ABS} "
            f"on rgb and accumulation), the card's rgb where the accumulation < 1e-3: {bg:.4f} on {card}")
        if (loss_rel > STEP_LOSS_RTOL or max(terms.values()) > STEP_LOSS_RTOL or grad_rel[worst] > STEP_GRAD_REL
                or max(mean["rgb"], mean["accumulation"]) > CARD_VS_CPU_MEAN_ABS):
            raise AssertionError(f"{name}: card and CPU {method} steps or eval chunks disagree")
        rec.update(loss_rel=loss_rel, terms=terms, grad_rel=grad_rel[worst], eval_mean=mean, eval_max=peak,
                   background=color, empty_rgb=bg)
        if method == "tensorf":
            rec["k8"] = k8_step(name, run, card)
        return rec

    return after


def double_backward_refused(name, card):
    """The hand-written kernels' autograd functions under a double backward
    on the card. K1 is differentiable twice: the gradient in the positions
    of <d, u> (d the position gradient of <K1(p), G>, taken with
    ``create_graph=True``) must equal the float64 twin of K1bb in the
    positions, the table and G within ``k1bb_bounds`` (levels 0 and 2 at
    scale 2, 1 and 3 at 0: the subsampled backward), and a cotangent of its
    table gradient must raise NotImplementedError. K7's, K4's and K6's
    gradients taken with ``create_graph=True`` must equal a plain
    backward's (within 1e-5 of their peak: the backwards sum with float
    atomics, in no fixed order), and their own backward must raise (once
    differentiable). Returns {kernel: largest gap / peak}, K1's over its
    bounds' largest ratio."""
    from nerfstudio_torch.ops import hash_grid as hg
    from nerfstudio_torch.ops.gsplat import projection as pj
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    geom = dict(num_levels=4, min_res=4, max_res=64, hash_table_size=2**12)
    pos = torch.rand((4096, 3), generator=gen, device="cuda").requires_grad_(True)
    table = (torch.rand((4, 64, 128), generator=gen, device="cuda") * 2 - 1).requires_grad_(True)
    means = (torch.rand((256, 3), generator=gen, device="cuda") - 0.5) * 1.5 + torch.tensor([0.0, 0.0, 3.0],
                                                                                             device="cuda")
    scales = torch.full((256, 3), 0.05, device="cuda")
    quats = torch.nn.functional.normalize(torch.randn((256, 4), generator=gen, device="cuda"), dim=-1)
    cam = (64.0, 64.0, 32.0, 32.0, 64, 64)
    with torch.no_grad():
        m2, dep, con, radii, valid, _ = pj.project_gaussians(means, scales, quats, torch.eye(4), *cam)
    colors = torch.rand((256, 3), generator=gen, device="cuda").requires_grad_(True)

    # K1: differentiable twice
    cot = torch.randn((4096, 8), generator=gen, device="cuda").requires_grad_(True)
    u = torch.randn((4096, 3), generator=gen, device="cuda")
    levels, kw = (0, 2), {k: v for k, v in geom.items() if k != "num_levels"}
    level_scales = [2.0 if l in levels else 0.0 for l in range(4)]
    out = hg.hash_encode(pos, table, block=True, bwd_levels=levels, bwd_scale=2.0, **geom)
    (d,) = torch.autograd.grad((out * cot).sum(), pos, create_graph=True)
    got = torch.autograd.grad((d * u).sum(), (cot, table, pos))
    ref = hg._block_stochastic_twin_bwd_bwd(pos.detach(), table.detach(), cot.detach(), u, level_scales,
                                            dtype=torch.float64, **kw)
    limits = k1bb_bounds(pos.detach(), table.detach(), cot.detach(), u, level_scales, kw)
    ratio = max(float(((a.double() - b).abs() / lim).max()) for a, b, lim in zip(got, ref, limits))
    (g_table,) = torch.autograd.grad((hg.hash_encode(pos, table, block=True, **geom) * cot).sum(), table,
                                     create_graph=True)
    try:
        torch.autograd.grad(g_table.square().sum(), pos)
        table_raised = False
    except NotImplementedError:
        table_raised = True
    if not (ratio <= 1.0 and table_raised):
        raise AssertionError(f"{name}: K1's double backward on the card: {ratio:.3g} of its limit against the "
                             f"float64 twin, a table-gradient cotangent refused {table_raised}")
    out = {"K1": ratio}

    def k6(c):
        rgb, alpha, _ = rz.rasterize(m2, con, c, torch.full((256,), 0.6, device="cuda"), dep, radii, valid,
                                     width=64, height=64)
        return (rgb * rgb).sum() + alpha.sum()

    cases = {
        "K7": ((pos, table), lambda: 0.5 * hg.hash_encode(pos, table, **geom).square().sum()),
        "K4": ((means.requires_grad_(True),), lambda: pj.project_gaussians(means, scales, quats, torch.eye(4),
                                                                          *cam)[0].square().sum()),
        "K6": ((colors,), lambda: k6(colors)),
    }
    for k, (inputs, loss) in cases.items():
        grads = torch.autograd.grad(loss(), inputs, create_graph=True)
        plain = torch.autograd.grad(loss(), inputs)
        gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(grads, plain))
        same = gap <= 1e-5
        try:
            sum(g.square().sum() for g in grads).backward()
            raised = False
        except RuntimeError as e:
            raised = "once_differentiable" in str(e)
        if not (same and raised):
            raise AssertionError(f"{name}: {k}'s double backward on the card: first order gap {gap:.3g} of the "
                                 f"peak, second order refused {raised}")
        out[k] = gap
    log(name, f"K1's double backward on the card (bwd_levels (0, 2) at scale 2) against its float64 twin: "
        f"{out['K1']:.3g} of its summation-order limit at worst (d_grad, d_table, d_positions), a cotangent of "
        f"its table gradient refused; a double backward through K7, K4 and K6 raises (once differentiable), the "
        f"gradients taken with create_graph against a plain backward's, max gap / peak: "
        + ", ".join(f"{k} {out[k]:.2g}" for k in cases) + f" (limit 1e-5) on {card}")
    return out


def blender_methods(ph, card, disk_root, disk):
    """Phases 61-63: a double backward through the kernels refused on the
    card (``double_backward_refused``); tensorf (BLENDER_RUNS' steps,
    through its first grid upsample), vanilla-nerf and mipnerf on the blender scene of phase 57
    through ``scripts.gate``'s loop, each checked at its trained state
    (``gate_phase`` with ``blender_after``; none launches a hand-written
    kernel), profiled over 3 steps by class, and tensorf's K8 at its step's
    own calls. Adds the runs to ``disk``; returns (tensorf's K8 record, the
    double backward's record)."""
    blender = os.path.join(disk_root, "blender")
    double = double_backward_refused(ph(61, "double backward"), card)
    k8 = None
    for i, (method, steps) in enumerate(BLENDER_RUNS):
        name = ph(61 + i, f"{method} on blender, {steps} steps")
        rec = disk[f"gate_{method}"] = gate_phase(name, method, blender, disk_root, card, (), steps=steps,
                                                  after=blender_after(name, method, card))
        if rec["scene"] != "blender":
            raise AssertionError(f"{name}: the gate ran {method} on {rec['scene']}")
        idle = rec["idle"]
        if method == "tensorf":
            k8 = rec["after"]["k8"]
            k8["busy_ms"] = None if idle is None else idle["busy_ms"]
            k8["share"] = None if idle is None else k8["device_ms"] / idle["busy_ms"]
            log(name, "K8's share of the profiled step's device-busy time: " + (
                "not measured" if idle is None else f"{k8['share']:.1%} ({k8['device_ms']:.4f} of "
                f"{idle['busy_ms']:.2f} ms)") + f" on {card}")
        if idle is not None:
            cls = idle["classes"]
            log(name, f"{method}: {rec['train_rays_per_sec']:,.0f} rays/s over the run (host clock); per profiled "
                f"step {idle['busy_ms']:.2f} ms device-busy, idle {idle['idle']:.1%}; GEMMs "
                f"{cls.get('GEMMs', 0.0):.3f} ms, elementwise {cls.get('elementwise', 0.0):.3f}, "
                f"index/scatter/gather (K8's gathers and scatters among them) {cls.get('index/scatter/gather', 0.0):.3f}"
                f" on {card}")
    return k8, double


# -- instant-ngp and nerfacto's sampling options (phases 64-66) ---------------

# instant-ngp (scene contraction) and instant-ngp-bounded on the blender
# scene of phase 57 through scripts.gate's loop at their shipped configs,
# cut in depth: instant-ngp to 500 of its gate's 5000 steps (past the
# 256-step grid warm-up: ~15 whole-grid refreshes), the bounded variant to
# 300 of 3000 (the full gates: their own chip call, PERF.md)
NGP_RUNS = (("instant-ngp", 500), ("instant-ngp-bounded", 300))
NGP_CHECK_RAYS = 1024  # the card-vs-CPU step
# the refresh card vs CPU: each density within 1e-4 of the CPU's, relative
# (plus 1e-6 absolute), the binary cells equal on 99.9% of the grid
REFRESH_RTOL, REFRESH_ATOL, REFRESH_CELLS = 1e-4, 1e-6, 0.999
NERFACTO_OPTIONS = (("both proposal nets, no occupancy grid", dict(use_occupancy_sampler=False)),
                    ("the grid's PDF alone over its EMA densities",
                     dict(num_proposal_iterations=0, occ_weight_mode="density")))


def float32_mlps(model):
    """Every MLP of ``model`` computes its products in float32."""
    from nerfstudio_torch.field_components.mlp import MLP

    for m in model.modules():
        if isinstance(m, MLP):
            m.dtype = torch.float32


def ngp_refresh(name, run, card):
    """One whole-grid refresh at the trained state, as the hook runs it at
    the next refresh step (every cell at a jittered point, K1 forward
    without a graph): K1 at its captured inputs, every design against the
    twin, timed in turns (events, device, back to back) beside the twin's
    time and its bounds (the whole table; each touched 128-byte line once);
    then the same refresh with the same jitter on the card and on the CPU,
    copies of the trained model computing their MLPs in float32: densities
    within REFRESH_RTOL, cells equal on REFRESH_CELLS of the grid."""
    from nerfstudio_torch.ops import hash_grid as hg

    pipeline, state = run["pipeline"], run["state"]
    model, cfg = pipeline.model, pipeline.model.config
    res = cfg.grid_resolution
    step = (int(state.step) // cfg.grid_update_every + 1) * cfg.grid_update_every
    jitter = torch.rand((res**3, 3), generator=torch.Generator(device="cuda").manual_seed(SEED + 11), device="cuda")
    hook = type(model).make_aux_update_fn(model, cfg)
    calls = capture_kernel_calls({"fwd": (hg, "_block_kernel")},
                                 lambda: hook(types.SimpleNamespace(aux=state.aux), step, jitter=jitter))["fwd"]
    if len(calls) != 1:
        raise AssertionError(f"{name}: a grid refresh called K1 {len(calls)} times, not once")
    (pos, table), kw = calls[0]
    kw = dict(kw)
    kw.pop("exact")
    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    n = pos.shape[0]
    what = (f"K1 fwd at one whole-grid refresh of the trained state (step {step}): N={n} L={L} F={F} "
            f"T=2^{kw['hash_table_size'].bit_length() - 1} max_res={kw['max_res']}, table "
            f"{nbytes(table) / 2**20:.0f} MiB")
    errs, timing, fn_bound = check_block_designs(name, False, pos, table, kw, what)
    events, dev, bat = time_block_designs(timing)
    with torch.no_grad():
        twin_ms = median_ms(timing["twin"], runs=3, warmup=1)
    lines = touched_line_bytes(pos, table, kw, False)
    line_bound = bound(nbytes(pos) + n * L * F * 4 + lines, hash_fwd_ops(n, L, F))
    design = hg._pick_design(F)
    rec = dict(kernel="K1 fwd", inputs="one whole-grid refresh", n=n, levels=L, features=F,
               hash_table_size=kw["hash_table_size"], max_res=kw["max_res"], table_bytes=nbytes(table),
               touched_bytes=lines, design=design, plain_ms=twin_ms, bound_ms=fn_bound[0], bound_by=fn_bound[1],
               line_bound_ms=line_bound[0], line_bound_by=line_bound[1],
               designs={d: dict(ms=events[d][0], ms_runs=events[d][1], device_ms=dev[d], batch_ms=bat[d],
                                max_abs_err=errs[d]) for d in hg.DESIGNS})
    del calls, pos, table
    grids = []
    for device in ("cuda", "cpu"):
        twin = copy.deepcopy(model).to(device).train()
        float32_mlps(twin)
        holder = types.SimpleNamespace(aux=state.aux.to(device))
        type(twin).make_aux_update_fn(twin, cfg)(holder, step, jitter=jitter.to(device))
        grids.append(holder.aux)
        del twin
    card_g, cpu_g = grids
    gap = (card_g.densities.cpu() - cpu_g.densities).abs()
    over = float((gap / (REFRESH_RTOL * cpu_g.densities.abs() + REFRESH_ATOL)).max())
    big = cpu_g.densities.abs() > 1e-2
    rel = float((gap[big] / cpu_g.densities[big].abs()).max()) if bool(big.any()) else 0.0
    cells = float((card_g.binary.cpu() == cpu_g.binary).float().mean())
    occupied = float(cpu_g.binary.float().mean())
    d = rec["designs"][design]
    log(name, f"{what} on {card}: {design} {d['ms']:.4f} ms (events), device {d['device_ms']:.4f}, back to back "
        f"{d['batch_ms']:.4f}; bound {line_bound[0]:.4f} ms by {line_bound[1]} (the touched lines, "
        f"{lines / 2**20:.1f} MiB; the whole table's {fn_bound[0]:.4f}); twin {twin_ms:.3f} ms; the other designs: "
        + ", ".join(f"{k} {v['ms']:.4f} / {v['device_ms']:.4f} / {v['batch_ms']:.4f}" for k, v in rec["designs"].items()
                    if k != design)
        + f". The refresh card vs CPU (the same jitter, the MLPs in float32): densities max |card - cpu| / "
        f"({REFRESH_RTOL} |cpu| + {REFRESH_ATOL}) = {over:.3g} (limit 1; {rel:.3g} relative where the density "
        f"> 0.01), cells equal on {cells:.6f} of {res}^3 (limit {REFRESH_CELLS}); {occupied:.3f} of the cells "
        f"occupied")
    if over > 1.0 or cells < REFRESH_CELLS:
        raise AssertionError(f"{name}: the grid refresh on the card and on the CPU disagree")
    rec.update(card_vs_cpu=dict(over=over, rel=rel, cells=cells, occupied=occupied, step=step))
    return rec


def ngp_step_card_vs_cpu(run, method):
    """One training step at the trained state on the card and on the CPU:
    copies of the trained model with every hash table set flat per level
    and feature and every MLP computing in float32, the trained grid, the
    run's train images and cameras, the same NGP_CHECK_RAYS pixels, PDF
    jitter and random background drawn on the host, a fresh optimizer each.
    Returns (card metrics, CPU metrics, loss rel, grads rel, tables rel,
    {term: rel})."""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws, TrainState, VanillaPipeline

    pipeline, state = run["pipeline"], run["state"]
    dm, trained = pipeline.datamanager, pipeline.model
    gen = torch.Generator().manual_seed(SEED + 12)
    n, h, w = dm.train_images.shape[:3]
    pixels = torch.stack([torch.randint(0, m, (NGP_CHECK_RAYS,), generator=gen) for m in (n, h, w)], dim=-1)
    jitter = torch.rand((NGP_CHECK_RAYS, 1), generator=gen)
    background = torch.rand((NGP_CHECK_RAYS, 3), generator=gen)
    weights, runs = None, []
    for device in ("cuda", "cpu"):
        model = copy.deepcopy(trained).to(device).train()
        if weights is None:
            flatten_tables(model, torch.Generator().manual_seed(SEED + 2))
            weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        float32_mlps(model)
        data = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=NGP_CHECK_RAYS),
                                      dm.train_cameras.to(device), dm.train_images.cpu(), device)
        twin = VanillaPipeline(data, model)
        st = TrainState(PerGroupAdam(get_method(method).optimizers, model), aux=state.aux.to(device))
        metrics = twin.train_step(st, draws=StepDraws(pixels.to(device), SamplerUniforms(None, (jitter.to(device),)),
                                                      background.to(device)))
        grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters() if p.grad is not None}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, model))
        del twin, st, data
    (m_card, g_card, model), (m_cpu, g_cpu, _) = runs
    terms = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu if k.endswith("_loss")}
    return (m_card, m_cpu) + step_rel(m_card, g_card, m_cpu, g_cpu, model) + (terms,)


def ngp_eval_card_vs_cpu(run):
    """One eval chunk (the model's eval_num_rays_per_chunk rays spread evenly
    over the first test view) through the pipeline's eval path on the card,
    under the eval background override where the parser has an alpha
    colour, and through a CPU copy of the model over the same grid under the
    same override, both as shipped; K3's share of the card's chunk under the
    profiler. Returns ({output: mean |card - cpu|}, {output: max}, {"busy_ms",
    "k3_ms", "share"} or None)."""
    from nerfstudio_torch.model_components import renderers

    pipeline, state = run["pipeline"], run["state"]
    chunk = pipeline.model.config.eval_num_rays_per_chunk
    cams = pipeline.datamanager.eval_cameras
    rb = cams.generate_rays(camera_indices=pipeline.datamanager.eval_image(0)[0]).flatten()
    stride = max(rb.shape[0] // chunk, 1)
    rb = rb.map(lambda x: x[::stride][:chunk])
    card_rb = rb.map(lambda x: x.to("cuda"))
    card = pipeline.eval_rays(state, card_rb)
    model = copy.deepcopy(pipeline.model).to("cpu").eval()
    color = pipeline._eval_background()
    with torch.no_grad(), (contextlib.nullcontext() if color is None
                           else renderers.background_color_override_context(color.cpu())):
        cpu = model(rb.map(lambda x: x.cpu()), model_aux=state.aux.to("cpu"))
    keys = ("rgb", "accumulation", "depth")
    mean = {k: float((card[k].cpu() - cpu[k]).abs().mean()) for k in keys}
    peak = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in keys}
    prof = profile_device(lambda: pipeline.eval_rays(state, card_rb), per=1)
    share = None
    if prof is not None:
        rows, busy_ms, _, _ = prof
        k3_ms = sum(t for nm, t in rows if kernel_class(nm) == "hash-grid kernels")
        share = dict(busy_ms=busy_ms, k3_ms=k3_ms, share=k3_ms / busy_ms, rays=int(card_rb.shape[0]))
    del model
    return mean, peak, share


def ngp_after(name, method, card):
    """The checks at each instant-ngp trained state after the gate loop: the
    loss fell; K1's forward at one whole-grid refresh against the twin and
    timed, and the refresh card vs CPU (``ngp_refresh``); one step card vs
    CPU within phase 11's limits (every loss term too); one eval chunk card
    vs CPU (rgb and accumulation within CARD_VS_CPU_MEAN_ABS mean abs) and
    K3's share of it."""

    def after(run):
        head, tail, fell = loss_fell(run["base_dir"], "rgb_loss")
        if not fell:
            raise AssertionError(f"{name}: {method}'s rgb loss did not fall: {head} -> {tail}")
        refresh = ngp_refresh(name, run, card)
        m_card, m_cpu, loss_rel, grad_rel, table_rel, terms = ngp_step_card_vs_cpu(run, method)
        mean, peak, k3 = ngp_eval_card_vs_cpu(run)
        occupied = float(run["state"].aux.binary.float().mean())
        log(name, f"{method}: rgb loss {head:.5f} -> {tail:.5f} (first quarter's mean to the last's); the trained "
            f"grid has {occupied:.4f} of its cells occupied; one step at the trained state ({NGP_CHECK_RAYS} rays, "
            f"flat tables, the MLPs in float32, the PDF jitter and the background handed in) card vs CPU: loss "
            f"{m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {STEP_LOSS_RTOL}), terms "
            + ", ".join(f"{k} {v:.2g}" for k, v in terms.items())
            + f"; non-table gradients {grad_rel:.3g} of the peak (limit {STEP_GRAD_REL}); the table per level and "
            f"feature {table_rel:.3g} (limit {STEP_TABLE_SUM_REL}); one eval chunk, mean |card - cpu| "
            + ", ".join(f"{k} {v:.3g}" for k, v in mean.items()) + " (max "
            + ", ".join(f"{k} {v:.3g}" for k, v in peak.items()) + f"; limit {CARD_VS_CPU_MEAN_ABS} on rgb and "
            "accumulation); K3 in a profiled eval chunk: "
            + ("not measured" if k3 is None else f"{k3['k3_ms']:.4f} of {k3['busy_ms']:.4f} ms device-busy "
                                                 f"({k3['share']:.1%}, {k3['rays']} rays)") + f" on {card}")
        if (loss_rel > STEP_LOSS_RTOL or max(terms.values()) > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL
                or table_rel > STEP_TABLE_SUM_REL or max(mean["rgb"], mean["accumulation"]) > CARD_VS_CPU_MEAN_ABS):
            raise AssertionError(f"{name}: card and CPU {method} steps or eval chunks disagree")
        return dict(loss=(head, tail), occupied=occupied, refresh=refresh, loss_rel=loss_rel, terms=terms,
                    grad_rel=grad_rel, table_rel=table_rel, eval_mean=mean, eval_max=peak, k3_eval=k3)

    return after


def instant_ngp_methods(ph, card, disk_root, disk):
    """Phases 64-65: instant-ngp and instant-ngp-bounded on the blender scene
    of phase 57 through ``scripts.gate``'s loop (NGP_RUNS' steps), each
    checked at its trained state (``gate_phase`` with its kernels timed, and
    ``ngp_after``): the hash grid's share of the profiled steps and the
    launches per step. Adds the runs to ``disk``."""
    blender = os.path.join(disk_root, "blender")
    for i, (method, steps) in enumerate(NGP_RUNS):
        name = ph(64 + i, f"{method} on blender, {steps} steps")
        rec = disk[f"gate_{method}"] = gate_phase(name, method, blender, disk_root, card, NERFACTO_KERNELS,
                                                  steps=steps, timed=True, after=ngp_after(name, method, card))
        if rec["scene"] != "blender":
            raise AssertionError(f"{name}: the gate ran {method} on {rec['scene']}")
        per_step = {k: v / rec["steps"] for k, v in rec["gate_launches"]["train"].items() if v}
        idle = rec["idle"]
        if idle is not None:
            rec["hash_share"] = idle["classes"].get("hash-grid kernels", 0.0) / idle["busy_ms"]
        log(name, f"{method}: {rec['train_rays_per_sec']:,.0f} rays/s over the run (host clock); launches per "
            f"train step {per_step}; per profiled step "
            + ("not measured" if idle is None else
               f"{idle['busy_ms']:.2f} ms device-busy, idle {idle['idle']:.1%}, {idle['activities']:.0f} device "
               f"activities, the hash-grid kernels (K1 fwd and bwd) {idle['classes'].get('hash-grid kernels', 0.0):.3f}"
               f" ms ({rec['hash_share']:.1%})") + f" on {card}")


def nerfacto_option_steps(name, card):
    """Phase 66: one full-width nerfacto step with each of NERFACTO_OPTIONS
    on the card and on the CPU twins (``card_vs_cpu_step``: flat tables, the
    same grid and draws), within phase 11's limits. Returns {option: rels}."""
    out = {}
    for label, options in NERFACTO_OPTIONS:
        zero_counts()
        m_card, m_cpu, loss_rel, grad_rel, table_rel = card_vs_cpu_step(options=options)
        counts = {k: v for k, v in read_counts().items() if v}
        log(name, f"nerfacto with {label} ({options}), one step at step 300 ({CHECK_RAYS} rays, flat tables) card "
            f"vs CPU: loss {m_card['loss']:.6f} vs {m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {STEP_LOSS_RTOL}), "
            f"interlevel {m_card['interlevel_loss']:.6f} vs {m_cpu['interlevel_loss']:.6f}; non-table gradients "
            f"{grad_rel:.3g} of the peak (limit {STEP_GRAD_REL}); tables per level and feature {table_rel:.3g} "
            f"(limit {STEP_TABLE_SUM_REL}); the card step's launches {counts} on {card}")
        if (loss_rel > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL or table_rel > STEP_TABLE_SUM_REL
                or not counts.get("hash_encode_block") or not counts.get("hash_encode_block_bwd")):
            raise AssertionError(f"{name}: card and CPU nerfacto steps with {options} disagree")
        out[label] = dict(options=options, loss_rel=loss_rel, grad_rel=grad_rel, table_rel=table_rel,
                          launches=counts)
    return out



# --------------------------------------------------------------------------
# nerfacto with predict_normals: K3b (K3's position gradient, the eval
# normals) and K1bb (K1's backward differentiated again, the normals' loss)


NORMALS_STEPS = 800  # phase 67, cut in depth from the cell's 5000 (full run: PERF.md §6)
NORMALS_FLAGS = ["--model.predict-normals", "True"]
NORMALS_KERNELS = NERFACTO_KERNELS + ("hash_encode_block_bwd_bwd", "hash_encode_block_exact_bwd")
NORMALS_EVAL_RAYS = 4096  # the card-vs-CPU eval chunk (the CPU renders it with the normals' gradient)
NORMALS_TERMS = ("orientation_loss", "pred_normal_loss")


def k1bb_bounds(pos, table, g, u, scales, kw):
    """Per-entry limits on |K1bb - float64 twin| of (d_grad, d_table,
    d_positions), from the float64 sums of the terms' magnitudes over the
    geometry: |h_c| <= sum_a |u_a| |dw_a| |w_b| |w_c| (the three products
    of h_c, each rounded four times, and two adds), the table values
    bf16-rounded as read. A float32 sum of k terms in any order is off by at
    most (k-1) u sum|t|; each term's own roundings add a few u more:
    d_grad 8 corners and ~8 roundings a term; d_table (its atomics'
    k terms an entry) 8 roundings a term and FLT_MIN a term and a partial
    sum (atomics flush subnormals to zero); d_positions 2F + 8 roundings a
    corner term (a_c's F products and sums, the second-derivative products),
    8 corners, L levels. Subnormal results round to 2^-150 absolute:
    SUBNORMAL_ULP per rounding, times res (d_grad) or res^2 (d_positions)
    for the scaling inside the terms."""
    from nerfstudio_torch.ops import hash_grid as hg

    L, S, lanes = table.shape
    T = kw["hash_table_size"]
    F = 128 * S // T
    n = pos.shape[0]
    dev = pos.device
    grad_sum = torch.zeros((n, L * F), dtype=torch.float64, device=dev)
    tab_sum = torch.zeros((L, S * lanes), dtype=torch.float64, device=dev)
    counts = torch.zeros((L, S * lanes), dtype=torch.float64, device=dev)
    pos_sum = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    ua = u.abs().double()
    res_all = hg.compute_level_resolutions(L, kw["min_res"], kw["max_res"])
    with torch.no_grad():
        for l, res in enumerate(res_all):
            idx, phi, dphi = hg._stochastic_level(pos, int(res), T, F)
            phi = [(a.double().abs(), b.double().abs()) for a, b in phi]
            dphi = [(a.double().abs(), b.double().abs()) for a, b in dphi]
            vals = hg._bf16(table[l].reshape(-1)[idx]).double().abs().view(n, 8, F)
            ga = g[:, l * F:(l + 1) * F].abs().double()
            habs, second = [], []
            for c in range(8):
                bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
                p = [phi[a][bits[a]] for a in range(3)]
                d = [dphi[a][bits[a]] for a in range(3)]
                habs.append(ua[:, 0] * d[0] * p[1] * p[2] + ua[:, 1] * p[0] * d[1] * p[2]
                            + ua[:, 2] * p[0] * p[1] * d[2])
                second.append(torch.stack([d[0] * (d[1] * p[2] * ua[:, 1] + p[1] * d[2] * ua[:, 2]),
                                           d[1] * (d[0] * p[2] * ua[:, 0] + p[0] * d[2] * ua[:, 2]),
                                           d[2] * (d[0] * p[1] * ua[:, 0] + p[0] * d[1] * ua[:, 1])], dim=-1))
            habs = torch.stack(habs, dim=-1)
            grad_sum[:, l * F:(l + 1) * F] = (habs[:, :, None] * vals).sum(dim=1)
            if scales[l]:
                terms = abs(scales[l]) * habs[:, :, None] * ga[:, None, :]
                tab_sum[l].index_add_(0, idx.reshape(-1), terms.reshape(-1))
                live = (habs != 0)[:, :, None].expand(n, 8, F)
                counts[l] += torch.bincount(idx.view(n, 8, F)[live], minlength=S * lanes).double()
            a_abs = (ga[:, None, :] * vals).sum(dim=-1)
            pos_sum += (a_abs[:, :, None] * torch.stack(second, dim=1)).sum(dim=1)
    top = float(max(res_all))
    grad_b = 16 * (U32 * grad_sum + SUBNORMAL_ULP * top)
    tab_b = ((counts + 8.0) * (U32 * tab_sum + FLT_MIN)).view(L, S, lanes)
    k = 2 * F + 16 + 8 + L
    pos_b = k * (U32 * pos_sum + SUBNORMAL_ULP * top * top)
    return grad_b, tab_b, pos_b


def check_k1bb(name, pos, table, g, u, scales, kw, what, needs):
    """K1bb in every design against its float64 twin within ``k1bb_bounds``;
    the levels of scale 0 untouched in the table gradient; the default
    design run twice: d_grad and d_positions bit-equal, d_table within its
    bounds again (its atomics add in any order); d_grad the same bits in
    both designs (each sums a stencil's corners in corner order). Returns
    its record, the default design's errors at the top and every design's
    under ``designs``."""
    from nerfstudio_torch.ops import hash_grid as hg

    ref = hg._block_stochastic_twin_bwd_bwd(pos, table, g, u, scales, dtype=torch.float64, **needs, **kw)
    bounds = k1bb_bounds(pos, table, g, u, scales, kw)
    keys = [k for k, want in zip(("d_grad", "d_table", "d_positions"), ("need_grad", "need_table", "need_positions"))
            if needs[want]]
    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    default = hg._pick_design(F)

    def errors(got):
        errs, overs = {}, {}
        for key, a, b, lim in zip(("d_grad", "d_table", "d_positions"), got, ref, bounds):
            if key in keys:
                err = (a.double() - b).abs()
                errs[key] = (float(err.max()), float(b.abs().max()))
                overs[key] = int((err > lim).sum()) + int((~torch.isfinite(a)).sum())
        silent = not needs["need_table"] or all(not got[1][l].any() for l, s in enumerate(scales) if not s)
        return errs, overs, silent

    designs, bad, d_grads = {}, [], {}
    for d in hg.DESIGNS:
        got = hg._block_bwd_bwd_kernel(pos, table, g, u, scales, _design=d, **needs, **kw)
        torch.cuda.synchronize()
        d_grads[d] = got[0]
        errs, overs, silent = errors(got)
        rec = dict(max_abs_err=max(e for e, _ in errs.values()),
                   errors={k: dict(max_abs=e, peak=p) for k, (e, p) in errs.items()}, over=overs, silent=silent)
        if d == default:
            again = hg._block_bwd_bwd_kernel(pos, table, g, u, scales, _design=d, **needs, **kw)
            torch.cuda.synchronize()
            rec["rerun_bit_equal"] = {k: same_bits(a, b) for k, a, b in zip(("d_grad", "d_table", "d_positions"),
                                                                               got, again)
                                      if k in keys and k != "d_table"}
            rec["rerun_over"] = errors(again)[1]
            if not all(rec["rerun_bit_equal"].values()) or any(rec["rerun_over"].values()):
                bad.append(f"{d} (rerun)")
        designs[d] = rec
        if any(overs.values()) or not silent:
            bad.append(d)
    same_d_grad = None if not needs["need_grad"] else same_bits(*d_grads.values())
    if same_d_grad is False:
        bad.append("d_grad differs between the designs")
    log(name, f"K1bb vs float64 twin, {what}: N={pos.shape[0]} L={L} F={F} "
        f"T=2^{kw['hash_table_size'].bit_length() - 1} scales={list(scales)} {needs}: " + "; ".join(
            f"{d}: max |kernel - twin| (peak) " + ", ".join(f"{k} {e['max_abs']:.3g} ({e['peak']:.3g})"
                                                           for k, e in r["errors"].items())
            + f", entries over their summation-order limit {r['over']}, scale-0 levels untouched {r['silent']}"
            + (f", a second run bit-equal {r['rerun_bit_equal']} (d_table over its limit {r['rerun_over'].get('d_table', 0)})"
               if "rerun_bit_equal" in r else "") for d, r in designs.items())
        + f"; d_grad the same bits in both designs: {same_d_grad}")
    if bad:
        raise AssertionError(f"{name}: K1bb disagrees with its twin ({what}): {bad}")
    return dict(inputs=what, n=int(pos.shape[0]), scales=list(scales), design=default, same_d_grad=same_d_grad,
                **{k: v for k, v in designs[default].items() if k in ("max_abs_err", "errors", "over")},
                designs=designs)


def check_k3b(name, pos, table, g, kw, what):
    """K3b in every design against its float64 twin within
    ``position_grad_bound`` (the position gradient of K3 has K1 backward's
    structure: per level a signed sum of 8 corner terms of F products,
    times res); the default design run twice, bit-equal. Returns its
    record, the default design's error at the top and every design's under
    ``designs``."""
    from nerfstudio_torch.ops import hash_grid as hg

    ref = hg._block_exact_twin_bwd(pos, table, g, dtype=torch.float64, **kw)
    L, S, _ = table.shape
    F = 128 * S // kw["hash_table_size"]
    limit = position_grad_bound(g, table, L, F, kw["min_res"], kw["max_res"])
    default = hg._pick_design(F)
    designs, bad = {}, []
    for d in hg.DESIGNS:
        got = hg._block_exact_bwd_kernel(pos, table, g, _design=d, **kw)
        torch.cuda.synchronize()
        err = (got.double() - ref).abs()
        over = int((err > limit).sum()) + int((~torch.isfinite(got)).sum())
        designs[d] = dict(max_abs_err=float(err.max()), over=over)
        if d == default:
            again = hg._block_exact_bwd_kernel(pos, table, g, _design=d, **kw)
            torch.cuda.synchronize()
            designs[d]["rerun_bit_equal"] = same_bits(got, again)
            if not designs[d]["rerun_bit_equal"]:
                bad.append(f"{d} (rerun)")
        if over:
            bad.append(d)
    log(name, f"K3b vs float64 twin, {what}: N={pos.shape[0]} L={L} F={F} T=2^{kw['hash_table_size'].bit_length() - 1}"
        f" (peak {float(ref.abs().max()):.3g}): " + "; ".join(
            f"{d}: max |kernel - twin| {r['max_abs_err']:.3g}, entries over their summation-order limit {r['over']}"
            + (f", a second run bit-equal {r['rerun_bit_equal']}" if "rerun_bit_equal" in r else "")
            for d, r in designs.items()))
    if bad:
        raise AssertionError(f"{name}: K3b disagrees with its twin ({what}): {bad}")
    return dict(inputs=what, n=int(pos.shape[0]), design=default, max_abs_err=designs[default]["max_abs_err"],
                peak=float(ref.abs().max()), designs=designs)


# each design's kernel, by the name the profiler gives it
NORMALS_KERNEL_NAMES = {
    "K3b": {"per-thread": "block_exact_bwd_kernel", "lane-groups": "block_exact_bwd_lanes_kernel"},
    "K1bb": {"per-thread": "block_bwd_bwd_kernel", "lane-groups": "block_bwd_bwd_lanes_kernel"},
}


def time_normals_designs(rec, run, twin, moved, ops, names):
    """Every design of one kernel timed at one input set: in turns by CUDA
    events (``paired_ms``), by the profiler's device ms of its kernel's
    records, and over 50 calls back to back; the twin's events ms, the
    bound. Adds them to ``rec`` (the default design's at the top)."""
    from nerfstudio_torch.ops import hash_grid as hg

    fns = {d: (lambda d=d: run(d)) for d in hg.DESIGNS}
    paired = paired_ms(fns)
    for d, fn in fns.items():
        dev, records = kernel_records_ms(fn, names[d])
        rec["designs"][d].update(ms=paired[d][0], ms_runs=paired[d][1], device_ms=dev, device_records=records,
                                 batch_ms=batch_ms(fn))
    bnd = bound(moved, ops)
    rec.update({k: rec["designs"][rec["design"]][k] for k in ("ms", "device_ms", "device_records", "batch_ms")},
               plain_ms=median_ms(twin, runs=3, warmup=1), bound_ms=bnd[0], bound_by=bnd[1], bytes=moved)


def normals_kernel_records(name, sets, card):
    """Check and time K3b and K1bb in every design at each input set:
    {"K3b": [...], "K1bb": [...]} records with their times and bounds (the
    touched table lines read once, ``touched_line_bytes``; K1bb's dense
    table gradient written whole)."""
    from nerfstudio_torch.ops import hash_grid as hg

    out = {"K3b": [], "K1bb": []}
    for what, (pos, table, g), kw in sets["K3b"]:
        rec = check_k3b(name, pos, table, g, kw, what)
        L, S, _ = table.shape
        F = 128 * S // kw["hash_table_size"]
        n = pos.shape[0]
        moved = 2 * nbytes(pos) + nbytes(g) + touched_line_bytes(pos, table, kw, True)
        time_normals_designs(rec, lambda d: hg._block_exact_bwd_kernel(pos, table, g, _design=d, **kw),
                             lambda: hg._block_exact_twin_bwd(pos, table, g, **kw), moved,
                             n * L * (24 + 8 * (2 * F + 9)), NORMALS_KERNEL_NAMES["K3b"])
        out["K3b"].append(rec)
    for what, (pos, table, g, u, scales), kw, needs in sets["K1bb"]:
        rec = check_k1bb(name, pos, table, g, u, scales, kw, what, needs)
        L, S, _ = table.shape
        F = 128 * S // kw["hash_table_size"]
        n = pos.shape[0]
        moved = (nbytes(pos, g, u) + touched_line_bytes(pos, table, kw, False)
                 + (nbytes(g) if needs["need_grad"] else 0) + (nbytes(table) if needs["need_table"] else 0)
                 + (nbytes(pos) if needs["need_positions"] else 0))
        rec["needs"] = needs
        time_normals_designs(rec, lambda d: hg._block_bwd_bwd_kernel(pos, table, g, u, scales, _design=d, **needs, **kw),
                             lambda: hg._block_stochastic_twin_bwd_bwd(pos, table, g, u, scales, **needs, **kw), moved,
                             n * L * (30 + 8 * (4 * F + 40)), NORMALS_KERNEL_NAMES["K1bb"])
        out["K1bb"].append(rec)
    for k, recs in out.items():
        for r in recs:
            log(name, f"{k} at {r['inputs']} (N={r['n']}) on {card} (events: mean [two medians] / device ms "
                f"(records) / 50 back to back): " + ", ".join(
                    f"{d} {x['ms']:.4f} {[round(m, 4) for m in x['ms_runs']]} / {x['device_ms']:.4f} "
                    f"({x['device_records']}) / {x['batch_ms']:.4f}" for d, x in r["designs"].items())
                + f"; default {r['design']}; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                f"({r['bytes'] / 2**20:.1f} MiB); twin {r['plain_ms']:.3f} ms")
    return out


def normals_check_inputs(gen):
    """K3b at one shipped eval chunk's field samples (32,768 rays x 32) and
    K1bb at one from-disk step's (4096 rays x 32), at the field's width (L8
    F4 T=2^19, max_res 2048), K1bb at both phases of the period-2 cycle."""
    kw = dict(min_res=16, max_res=2048, hash_table_size=2**19)
    sets = {"K3b": [], "K1bb": []}
    pos, table = kernel_inputs(CHUNK * 32, 8, 19, 4, 16, 2048, "cuda", gen)
    g = torch.randn((pos.shape[0], 32), generator=gen, device="cuda")
    sets["K3b"].append(("check inputs", (pos, table, g), kw))
    n = 4096 * 32
    pos, table = kernel_inputs(n, 8, 19, 4, 16, 2048, "cuda", gen)
    g = torch.randn((n, 32), generator=gen, device="cuda")
    u = torch.randn((n, 3), generator=gen, device="cuda")
    needs = dict(need_grad=True, need_table=True, need_positions=True)
    for scales in ((2.0, 0.0) * 4, (0.0, 2.0) * 4):
        sets["K1bb"].append((f"check inputs, scales {scales[:2]}", (pos, table, g, u, scales), kw, needs))
    return sets


def pair_constant_tables(model, gen):
    """Hash tables on which K1's stochastic rounding changes no value, so a
    step's card and CPU runs agree though their sample positions differ in
    the last bits: on each dense level the value of vertex v depends on
    ((v + 1) >> 1) per axis (the two vertices an odd cell's coin chooses
    between hold one value; an even cell interpolates between two), drawn
    from ``gen``; a hashed level is flat (one value per feature; its
    vertices share entries). The dense levels keep a density gradient, so
    the normals live."""
    from nerfstudio_torch.field_components.encodings import HashEncoding
    from nerfstudio_torch.ops import hash_grid as hg

    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, HashEncoding):
                continue
            L, S, _ = m.hash_table.shape
            T, F = m.hash_table_size, m.features_per_level
            bpr = 16 // F
            tab = torch.empty((L, S * 128))
            for l, res in enumerate(hg.compute_level_resolutions(L, m.min_res, m.max_res)):
                bs, dense = hg._block_level_layout(int(res), T)
                if not dense:
                    tab[l] = (torch.rand((F,), generator=gen) * 2 - 1).repeat(S * 128 // F)
                    continue
                tab[l] = 0.0
                values = torch.rand((bs + 1, bs + 1, bs + 1, F), generator=gen) * 2 - 1
                b = torch.arange(bs**3)
                coords = (b // (bs * bs), (b // bs) % bs, b % bs)
                for c in range(8):
                    q = [(2 * coords[a] + ((c >> (2 - a)) & 1) + 1) >> 1 for a in range(3)]
                    lanes = (b // bpr) * 128 + (b % bpr) * (8 * F) + c * F
                    tab[l, lanes[:, None] + torch.arange(F)] = values[q[0], q[1], q[2]]
            m.hash_table.copy_(tab.view(L, S, 128).to(m.hash_table.device))


# The largest gap allowed between the card's and the CPU's positions at a
# hash encoding's input in the step card vs CPU with normals, in [0, 1]
# coordinates: two cells of the field's finest level (1 / 2048 each). The
# samplers' float32 sums in another order move a sample by a fraction of a
# cell (PERF.md); a sample that moved further is another sample.
POSITION_GAP = 1e-3


def replay_positions(model, replay=None):
    """Forward pre-hooks on every hash encoding of ``model``; returns (the
    list they fill, their handles). With ``replay`` None each call's input
    positions are appended (detached, on the CPU). Otherwise the calls take
    ``replay``'s positions in order, their gradient path unchanged (r + (x
    - x.detach()): the value r, the derivative 1), and the list receives
    each call's max |x - r|.

    K1's position gradient jumps at every cell face (an odd cell's axis has
    no slope, an even cell's has one: the reference's math), so the
    normals, the direction of the density gradient, turn where a sample
    moves across a face, and the card's and the CPU's positions differ in
    the last bits. Replaying the card's positions on the CPU holds the
    kernels and the twins to the same inputs; the gaps, held to
    POSITION_GAP, still check the positions."""
    from nerfstudio_torch.field_components.encodings import HashEncoding

    seen = []

    def hook(module, args, kwargs):
        x = args[0]
        if replay is None:
            seen.append(x.detach().cpu())
            return None
        r = replay[len(seen)].to(x.device)
        if r.shape != x.shape:
            raise AssertionError(f"hash encoding call {len(seen)}: positions {tuple(x.shape)} on the CPU, "
                                 f"{tuple(r.shape)} on the card")
        seen.append(float((x.detach() - r).abs().max()) if x.numel() else 0.0)
        return (r + (x - x.detach()),) + tuple(args[1:]), kwargs

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in model.modules()
               if isinstance(m, HashEncoding)]
    return seen, handles


def normals_step_card_vs_cpu(run):
    """One step at the trained state on the card and on the CPU twins:
    copies of the trained model with ``pair_constant_tables`` and every MLP
    in float32, the trained grid, the run's images and cameras, the same
    CHECK_RAYS pixels and jitter drawn on the host, the next step's kwargs,
    a fresh optimizer each. The CPU runs the step twice: at its own
    positions, and with every hash encoding taking the card's input
    positions (``replay_positions``), which the checks compare. Returns
    (card metrics, CPU metrics, loss rel, grads rel (the pose adjustment's
    among them), tables rel, {term: rel}, the pose adjustment's rel, the
    largest position gap, {"loss", "grads", "tables", "pose"}: the rels
    at the CPU's own positions)."""
    from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager
    from nerfstudio_torch.engine.optimizers import PerGroupAdam, nerfacto_optimizers
    from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
    from nerfstudio_torch.pipelines.base_pipeline import StepDraws, TrainState, VanillaPipeline

    pipeline, state = run["pipeline"], run["state"]
    dm, trained = pipeline.datamanager, pipeline.model
    kwargs = type(trained).step_kwargs(int(state.step), trained.config)
    gen = torch.Generator().manual_seed(SEED + 13)
    n, h, w = dm.train_images.shape[:3]
    pixels = torch.stack([torch.randint(0, m, (CHECK_RAYS,), generator=gen) for m in (n, h, w)], dim=-1)
    probes, *rounds = (torch.rand((CHECK_RAYS, 1), generator=gen) for _ in range(3))
    weights, runs, positions, gap = None, [], None, None
    for device, replay in (("cuda", False), ("cpu", False), ("cpu", True)):
        model = copy.deepcopy(trained).to(device).train()
        if weights is None:
            pair_constant_tables(model, torch.Generator().manual_seed(SEED + 14))
            with torch.no_grad():  # a pose adjustment off zero, so its gradient has a second-order part
                model.camera_optimizer.pose_adjustment.copy_(
                    1e-3 * torch.randn(model.camera_optimizer.pose_adjustment.shape, generator=gen))
            weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        float32_mlps(model)
        data = DeviceCacheDataManager(DataManagerConfig(train_num_rays_per_batch=CHECK_RAYS),
                                      dm.train_cameras.to(device), dm.train_images.cpu(), device)
        twin = VanillaPipeline(data, model)
        st = TrainState(PerGroupAdam(nerfacto_optimizers(), model), aux=state.aux.to(device))
        seen, hooks = replay_positions(model, positions if replay else None)
        metrics = twin.train_step(st, draws=StepDraws(pixels.to(device), SamplerUniforms(
            probes.to(device), tuple(u.to(device) for u in rounds[:model.num_proposal_rounds() + 1]))), **kwargs)
        for hook in hooks:
            hook.remove()
        if replay:
            if len(seen) != len(positions):
                raise AssertionError(f"the CPU step called the hash encodings {len(seen)} times, the card "
                                     f"{len(positions)}")
            gap = max(seen)
        elif positions is None:
            positions = seen
        grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters() if p.grad is not None}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, model))
        del twin, st, data
    (m_card, g_card, model), (m_own, g_own, _), (m_cpu, g_cpu, _) = runs
    terms = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu if k.endswith("_loss")}
    key = "camera_optimizer.pose_adjustment"
    pose = lambda g: float((g_card[key] - g[key]).abs().max() / g[key].abs().max().clamp_min(1e-30))  # noqa: E731
    own = dict(zip(("loss", "grads", "tables"), step_rel(m_card, g_card, m_own, g_own, model)), pose=pose(g_own))
    return (m_card, m_cpu) + step_rel(m_card, g_card, m_cpu, g_cpu, model) + (terms, pose(g_cpu), gap, own)


def float32_heads(model):
    """Every MLP and field head of ``model`` computes its products in
    float32 (``float32_mlps`` and the heads: the predicted-normal head)."""
    from nerfstudio_torch.field_components.field_heads import FieldHead

    float32_mlps(model)
    for m in model.modules():
        if isinstance(m, FieldHead):
            m.dtype = torch.float32
    return model


def normals_eval_card_vs_cpu(run):
    """One eval chunk (NORMALS_EVAL_RAYS rays spread over the first test
    view): the pipeline's eval path on the card as shipped, whose K3b calls
    are captured; then copies of the trained model on the card and on the
    CPU over the same grid (K3 and K3b on the card, their twins on the CPU),
    with every MLP and head in float32 and the proposal net's tables flat
    (``flatten_tables``: its K1 then gives one value whichever vertex its
    rounding picks, so both sides place the same samples). The normals are
    the direction of the density gradient, which the fine levels make turn
    from one sample position to the next: samples moved by the proposal's
    redrawn roundings (positions differ in the last bits between the card
    and the CPU) or bfloat16 products rounded another way give other
    normals, not a fault of K3b (measured 0.25 mean abs so). Returns
    ({output: mean |card - cpu|}, {output: max}, K3b's captured calls)."""
    from nerfstudio_torch.ops import hash_grid as hg

    pipeline, state = run["pipeline"], run["state"]
    cams = pipeline.datamanager.eval_cameras
    rb = cams.generate_rays(camera_indices=pipeline.datamanager.eval_image(0)[0]).flatten()
    stride = max(rb.shape[0] // NORMALS_EVAL_RAYS, 1)
    rb = rb.map(lambda x: x[::stride][:NORMALS_EVAL_RAYS])
    card_rb = rb.map(lambda x: x.to("cuda"))
    calls = capture_kernel_calls({"k3b": (hg, "_block_exact_bwd_kernel")},
                                 lambda: pipeline.eval_rays(state, card_rb))["k3b"]
    out, weights = {}, None
    for device, bundle in (("cuda", card_rb), ("cpu", rb.map(lambda x: x.cpu()))):
        model = float32_heads(copy.deepcopy(pipeline.model).to(device).eval())
        if weights is None:
            for net in model.proposal_networks:
                flatten_tables(net, torch.Generator().manual_seed(SEED + 16))
            weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        with torch.no_grad():
            out[device] = {k: v.cpu() for k, v in model(bundle, model_aux=state.aux.to(device)).items()
                           if isinstance(v, torch.Tensor)}
        del model
    keys = ("rgb", "accumulation", "normals", "pred_normals")
    mean = {k: float((out["cuda"][k] - out["cpu"][k]).abs().mean()) for k in keys}
    peak = {k: float((out["cuda"][k] - out["cpu"][k]).abs().max()) for k in keys}
    return mean, peak, calls


def normals_after(name, card):
    """The checks at the trained state of phase 67: the loss fell from the
    first quarter of the run to the last, and both normal terms from the
    second quarter to the last (the terms are sums over the rendering
    weights, which start near zero at the initial density: on the cell's
    full run both rise over the first ~300 steps and fall from there, past
    the first quarter's mean from ~1500 steps, PERF.md §6); K3b and K1bb against their twins at the inputs of one more
    step (K1bb) and of one eval chunk (K3b), timed; one step card vs CPU
    with the card's positions at the CPU's hash encodings (every loss term
    2e-3, gradients 5e-2 of the peak, the pose adjustment's too; the
    positions within POSITION_GAP); one eval chunk card vs CPU (the MLPs and heads in float32: rgb,
    accumulation, normals and predicted normals within
    CARD_VS_CPU_MEAN_ABS mean abs)."""
    from nerfstudio_torch.ops import hash_grid as hg

    def after(run):
        falls = {k: loss_fell(run["base_dir"], k, head_quarter=int(k in NORMALS_TERMS))
                 for k in ("loss", "rgb_loss") + NORMALS_TERMS}
        for k, (head, tail, fell) in falls.items():
            if not fell:
                raise AssertionError(f"{name}: nerfacto with normals: {k} did not fall: {head} -> {tail}")
        calls = capture_kernel_calls({"k1bb": (hg, "_block_bwd_bwd_kernel")}, run["one_step"])["k1bb"]
        mean, peak, k3b_calls = normals_eval_card_vs_cpu(run)
        if len(calls) != 1 or not k3b_calls:
            raise AssertionError(f"{name}: one step called K1bb {len(calls)} times, an eval chunk K3b "
                                 f"{len(k3b_calls)} times")
        sets = {"K3b": [], "K1bb": []}
        for (pos, table, g), kw in k3b_calls[:1]:
            sets["K3b"].append((f"a {NORMALS_EVAL_RAYS}-ray eval chunk of the trained state", (pos, table, g), kw))
        for (pos, table, g, u, scales), kw in calls:
            kw = dict(kw)
            needs = {k: kw.pop(k) for k in ("need_grad", "need_table", "need_positions")}
            sets["K1bb"].append(("a trained step", (pos, table, g, u, scales), kw, needs))
        kernels = normals_kernel_records(name, sets, card)
        m_card, m_cpu, loss_rel, grad_rel, table_rel, terms, pose_rel, gap, own = normals_step_card_vs_cpu(run)
        log(name, "nerfacto with normals: " + ", ".join(f"{k} {h:.6g} -> {t:.6g}" for k, (h, t, _) in falls.items())
            + f" (the first quarter's mean to the last's; the normal terms from the second quarter's); one step at "
            f"the trained state ({CHECK_RAYS} rays, tables "
            f"constant on the coin's vertex pairs, the MLPs in float32) card vs CPU at the CPU's own positions "
            f"(not held: the normals turn where a sample crosses a cell face): " + ", ".join(
                f"{k} {v:.3g}" for k, v in own.items()) + f"; with the card's positions at every hash encoding "
            f"(the CPU's {gap:.3g} away at most, limit {POSITION_GAP}): loss {m_card['loss']:.6f} vs "
            f"{m_cpu['loss']:.6f} (rel {loss_rel:.2g}, limit {STEP_LOSS_RTOL}), terms "
            + ", ".join(f"{k} {v:.2g}" for k, v in terms.items())
            + f" (orientation {m_card['orientation_loss']:.4g} vs {m_cpu['orientation_loss']:.4g}, pred-normal "
            f"{m_card['pred_normal_loss']:.4g} vs {m_cpu['pred_normal_loss']:.4g}); non-table gradients "
            f"{grad_rel:.3g} of the peak (pose adjustment {pose_rel:.3g}; limit {STEP_GRAD_REL}); tables per level "
            f"and feature {table_rel:.3g} (limit {STEP_TABLE_SUM_REL}); one eval chunk ({NORMALS_EVAL_RAYS} rays, "
            "the MLPs and heads in float32) "
            "mean |card - cpu| " + ", ".join(f"{k} {v:.3g}" for k, v in mean.items()) + " (max "
            + ", ".join(f"{k} {v:.3g}" for k, v in peak.items()) + f"; limit {CARD_VS_CPU_MEAN_ABS}) on {card}")
        if (loss_rel > STEP_LOSS_RTOL or max(terms.values()) > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_REL
                or pose_rel > STEP_GRAD_REL or table_rel > STEP_TABLE_SUM_REL or gap > POSITION_GAP
                or max(mean.values()) > CARD_VS_CPU_MEAN_ABS):
            raise AssertionError(f"{name}: card and CPU nerfacto-with-normals steps or eval chunks disagree")
        return dict(falls={k: v[:2] for k, v in falls.items()}, loss_rel=loss_rel, terms=terms, grad_rel=grad_rel,
                    pose_rel=pose_rel, table_rel=table_rel, position_gap=gap, own_positions=own, eval_mean=mean,
                    eval_max=peak, kernels=kernels)

    return after


def normals_phase(ph, card, scene, disk_root, disk):
    """Phase 67: K3b and K1bb against their float64 twins at the check
    inputs (``normals_check_inputs``) and timed; nerfacto with
    ``predict_normals`` trained from disk on the basic scene through
    ``scripts.gate``'s loop for NORMALS_STEPS steps (``gate_phase`` with the
    override, its own cell: every kernel of the path launched, the loss
    falls), then ``normals_after`` at the trained state. Returns the
    check-input records; adds the run to ``disk``."""
    name = ph(67, f"nerfacto with predict_normals on basic, {NORMALS_STEPS} steps")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    checks = normals_kernel_records(name, normals_check_inputs(gen), card)
    # a run directory of its own: phase 36's nerfacto run on the same scene
    # logged its scalars under disk_root's
    rec = disk["gate_nerfacto_normals"] = gate_phase(name, "nerfacto", scene, os.path.join(disk_root, "normals"),
                                                     card, NORMALS_KERNELS, steps=NORMALS_STEPS,
                                                     after=normals_after(name, card), overrides=NORMALS_FLAGS)
    per_step = {k: v / rec["steps"] for k, v in rec["gate_launches"]["train"].items() if v}
    idle = rec["idle"]
    log(name, f"nerfacto with normals: {rec['train_rays_per_sec']:,.0f} rays/s over the run (host clock); launches "
        f"per train step {per_step}, in the eval {({k: v for k, v in rec['gate_launches']['eval'].items() if v})}; "
        + ("per profiled step not measured" if idle is None else
           f"per profiled step {idle['busy_ms']:.2f} ms device-busy of {idle['step_ms']:.2f} ms, idle "
           f"{idle['idle']:.1%}, the hash-grid kernels {idle['classes'].get('hash-grid kernels', 0.0):.3f} ms")
        + f" on {card}")
    return checks


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
    from nerfstudio_torch.ops.gsplat import rasterize as rz

    n_phases = 67
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
                           "hash_encode_flat": 0, "hash_encode_flat_bwd": 0, "hash_encode_block_exact_bwd": 0,
                           "hash_encode_block_bwd_bwd": 0, "hash_encode_block_per_thread": 0,
                           "hash_encode_bwd_per_thread": 0, "hash_encode_flat_per_thread": 0,
                           "hash_encode_normals_per_thread": 0}:
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
    occ_update_bound, occ_probe_bound = occupancy_bounds(state.aux.resolution, cfg.occ_cells_per_update,
                                                         CHUNK * cfg.occ_num_probes)
    log(ph(9, "training, steps 256-259"), f"{TRAIN_RAYS} rays/step, loss {loss:.5f} at step 259, "
        f"occupied after the update at 256: {occupied:.3f}, launches {dict(hg.launch_counts)}, "
        f"{early_s:.2f} s including warm-up; occupancy bounds (stock ops, no kernel): the update of "
        f"{cfg.occ_cells_per_update} cells of {state.aux.resolution}^3 {occ_update_bound[0]:.4f} ms, the probe of "
        f"one {CHUNK}-ray render chunk's {CHUNK * cfg.occ_num_probes} positions {occ_probe_bound[0]:.4f} ms "
        "(by bytes)")
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
    # K5 in both designs at the check inputs and with one tile longer than
    # one block of the bucketed sort orders at once; a trained step's inputs
    # after phase 17
    k5_check = k5_args(x, projected)
    long_tile = overflow_args(k5_check)
    k5_recs = {"check": check_k5(ph(14, "K5 designs vs twin"), k5_check, "check inputs"),
               "overflow": check_k5(ph(14, "K5 designs vs twin"), long_tile,
                                    "check inputs with one tile longer than one sort")}
    bins = k5_recs["check"].pop("bins")
    k5_above = check_k5_above_limit(ph(14, "K5 above the tile limit"), k5_check, x["width"], x["height"])
    (k6_err, k6_bwd_err), k6_timing, k6_bounds, k6_walked = check_k6(ph(15, "K6 vs twin"), x, projected, bins,
                                                                     splat_gen)
    # K6 forward's designs at three inputs (phase 32): these, the long
    # tile's (its moved means and bins), a trained step's (after phase 17)
    (m2, z, con, *_), _ = projected
    k6_ch = torch.cat([x["colors"], z[:, None], torch.ones_like(z)[:, None]], dim=-1)
    k6_inputs = {"check inputs": (m2, con, k6_ch, x["opac"], bins, x["width"], x["height"]),
                 "check inputs with one long tile": (long_tile[0], con, k6_ch, x["opac"],
                                                     k5_recs["overflow"].pop("bins"), x["width"], x["height"])}
    del x, projected, bins, long_tile, m2, z, con, k6_ch

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
            + ", ".join(f"{c} {t:.3f}" for c, t in sorted(classes.items(), key=lambda kv: -kv[1]))
            + "; gsplat kernels (ms/step): " + gsplat_rows(rows))
        for name, t in rows[:12]:
            print(f"    {t:8.3f} ms/step  {name[:110]}", flush=True)
    # K5's and K6 backward's inputs in one more steady step (K6: phase 28)
    captured = capture_splat_calls(pipeline, state, splat_gen)
    k6_trained = captured["blend_bwd"]
    k6_inputs["a trained splat step's inputs"] = (*k6_trained[:5], k6_trained[5].shape[1], k6_trained[5].shape[0])
    k5_recs["trained"] = check_k5(ph(14, "K5 designs vs twin"), tuple(captured.pop("tile_bin")),
                                  "a trained splat step's inputs")
    del k5_recs["trained"]["bins"], captured
    refine_ms = median_ms(lambda: pipeline.refine(state, pipeline.refine_draws(splat_gen), do_split=True,
                                                  do_cull_scale=True, reset_alpha=False), runs=3, warmup=1)
    sc.reset_launch_counts()
    eval_metrics, out = pipeline.get_eval_image_metrics(state, 0)
    eval_launches = {k: sc.launch_counts[k] for k in SPLAT_KERNELS}
    for k, c in (("rgb", 3), ("accumulation", 1), ("depth", 1)):
        if tuple(out[k].shape) != (SPLAT_HW, SPLAT_HW, c) or not torch.isfinite(out[k]).all():
            raise AssertionError(f"eval {k}: shape {tuple(out[k].shape)} or non-finite values")
    want = dict.fromkeys(SPLAT_KERNELS, 0)
    want.update(project_gaussians=1, tile_bin=1, tile_bin_bucketed=1, blend_saturating=1)
    if eval_launches != want:
        raise AssertionError(f"eval render launches {eval_launches}, expected {want}")
    frame_ms = median_ms(lambda: pipeline.render_eval_image(state, 0), runs=10, warmup=2)
    log(ph(17, "splatfacto refine and eval"), f"refine {refine_ms:.2f} ms ({int(state.aux.alive.sum())} alive "
        f"after); eval render {SPLAT_HW}^2 at sh_degree 3: {frame_ms:.2f} ms/frame, psnr "
        f"{eval_metrics['psnr']:.2f}, ssim {eval_metrics['ssim']:.4f}, launches {eval_launches}")
    splat_frame_prof = profile_device(lambda: pipeline.render_eval_image(state, 0), per=1)
    if splat_frame_prof is None:
        log(ph(17, "splatfacto eval profile"), "torch.profiler saw no device activity: device time not measured")
    else:
        rows, busy_ms, activities, _ = splat_frame_prof
        log(ph(17, "splatfacto eval profile"), f"one {SPLAT_HW}^2 eval frame under torch.profiler: "
            f"{activities:.0f} device activities and {busy_ms:.3f} ms of device-busy time, i.e. the device idles "
            f"{1 - busy_ms / frame_ms:.1%} of the unprofiled {frame_ms:.2f} ms frame; gsplat kernels (ms/frame): "
            + gsplat_rows(rows))
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
        for key, fn in (("k4", k4_timing["fwd"]), ("k5", k5_recs["check"]["timing"]["bucketed"]),
                        ("k6", k6_timing["fwd"])):
            t[key] = median_ms(fn)
        for key, fn in (("k4_twin", k4_timing["fwd_twin"]), ("k5_twin", k5_recs["check"]["twin"]),
                        ("k6_twin", k6_timing["fwd_twin"])):
            t[key] = median_ms(fn, runs=3, warmup=1)
    t["k4_bwd"] = median_ms(k4_timing["bwd"])
    t["k6_bwd"] = median_ms(k6_timing["bwd"])
    with torch.no_grad():
        k4_dev = {"fwd": device_ms(k4_timing["fwd"]), "bwd": device_ms(k4_timing["bwd"])}
        k4_rec = {"fwd": kernel_records_ms(k4_timing["fwd"], "project_fwd"),
                  "bwd": kernel_records_ms(k4_timing["bwd"], "project_bwd")}
        k4_batch = {"fwd": batch_ms(k4_timing["fwd"]), "bwd": batch_ms(k4_timing["bwd"])}
    k6_bwd_check_fn = k6_timing["bwd"]
    t["k4_bwd_twin"] = median_ms(k4_timing["bwd_twin"], runs=3, warmup=1)
    t["k6_bwd_twin"] = median_ms(k6_timing["bwd_twin"], runs=3, warmup=1)
    t["k5_sort"] = median_ms(k5_recs["check"]["timing"]["torch.sort, live keys"])
    log(ph(19, "splatting timing"), f"on {card}: " + ", ".join(
        f"{k} {t[k]:.3f} ms (twin {t[k + '_twin']:.3f} ms)" for k in ("k4", "k4_bwd", "k5", "k6", "k6_bwd"))
        + f"; K4 device ms fwd {k4_dev['fwd']:.4f}, bwd {k4_dev['bwd']:.4f} (per kernel record "
        f"{k4_rec['fwd'][0]:.4f} of {k4_rec['fwd'][1]}, {k4_rec['bwd'][0]:.4f} of {k4_rec['bwd'][1]} records; 50 "
        f"calls back to back {k4_batch['fwd']:.4f}, {k4_batch['bwd']:.4f} ms a call)"
        + f"; torch.sort of K5's live keys alone {t['k5_sort']:.3f} ms; splatfacto step {splat_step_ms:.2f} ms, "
        f"refine {refine_ms:.2f} ms, eval frame {frame_ms:.2f} ms")
    del k4_timing, k6_timing
    # K5's designs and the two torch.sort yardsticks in turns at the three inputs
    for rec in k5_recs.values():
        time_k5(rec)
        del rec["timing"], rec["twin"]
    log(ph(14, "K5 designs, timing"), f"on {card} (events: mean [two medians] / device ms); "
        + "; ".join(k5_line(rec) for rec in k5_recs.values()) + "; default: bucketed")

    # 20-21. K7 forward and backward vs twins at the proposal nets' shapes:
    # round 1 (256 samples per ray) and round 2 (96)
    k7, k7_bwd_inputs = {}, {}
    prop_kw = dict(min_res=PROP_MIN_RES, max_res=PROP_MAX_RES, hash_table_size=2**PROP_LOG2_T)
    for i, samples in enumerate(NEUS_SAMPLES):
        n = NEUS_RAYS * samples
        pos, table = kernel_inputs(n, PROP_LEVELS, PROP_LOG2_T, PROP_F, PROP_MIN_RES, PROP_MAX_RES, "cuda", gen)
        k7[f"fwd_{samples}"] = check_flat(ph(20, f"K7 designs vs twin, {samples} samples/ray"), pos, table,
                                          prop_kw, "check inputs")
        del pos, table
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
    eval_launches = {k: hg.launch_counts[k] for k in NEUS_KERNELS + PER_THREAD}
    for k, c in (("rgb", 3), ("accumulation", 1), ("depth", 1), ("normals", 3)):
        if tuple(frame[k].shape) != (FRAME_HW, FRAME_HW, c) or not torch.isfinite(frame[k]).all():
            raise AssertionError(f"neus-facto eval {k}: shape {tuple(frame[k].shape)} or non-finite values")
    if eval_launches != dict(dict.fromkeys(NEUS_KERNELS + PER_THREAD, 0), hash_encode_flat=2 * chunks):
        raise AssertionError(f"neus-facto eval launches {eval_launches}, expected {2 * chunks} forward in the "
                             "default design, no backward")
    normal_len = float(torch.linalg.norm(frame["normals"], dim=-1).mean())
    first_frame_ms = neus_frame_ms
    neus_frame_ms = median_ms(lambda: render_camera(model, None, cams, 1, NEUS_RAYS), runs=1, warmup=0)
    log(ph(25, "neus-facto eval frame"), f"{FRAME_HW}^2 in {chunks} chunks of {NEUS_RAYS}: {neus_frame_ms:.1f} ms "
        f"(second frame, CUDA events; the first, with warm-up, {first_frame_ms:.1f} ms), mean accumulation "
        f"{float(frame['accumulation'].mean()):.3f}, mean |normal| {normal_len:.3f}, launches {eval_launches}")
    # the frame with K7's forward in each design, in turns; one profiled
    # frame in the default design; both K7 calls of its middle chunk (for
    # phase 20's check at the frame's own inputs)
    neus_frames = frames_in_turns(model, cams)
    flat_default = hg._pick_design(PROP_F)
    log(ph(25, "neus-facto frame by K7 design"), f"on {card}, in turns (CUDA events, mean [two frames]): "
        + ", ".join(f"{v} {ms:.1f} {[round(m, 1) for m in runs]}" for v, (ms, runs) in neus_frames.items())
        + f"; the default is {flat_default}")
    neus_prof = profile_device(lambda: render_camera(model, None, cams, 1, NEUS_RAYS), per=1)
    neus_frame_prof = None
    if neus_prof is None:
        log(ph(25, "neus-facto frame profile"), "torch.profiler saw no device activity: device time not measured")
    else:
        rows, busy_ms, activities, gemm_flops = neus_prof
        classes = {}
        for name, tm in rows:
            cls = "K7 (flat hash grid)" if is_k7(name) else kernel_class(name)
            classes[cls] = classes.get(cls, 0.0) + tm
        k7_ms = classes.get("K7 (flat hash grid)", 0.0)
        neus_frame_prof = dict(busy_ms=busy_ms, idle=1 - busy_ms / neus_frame_ms, activities=activities, k7_ms=k7_ms,
                               classes=classes)
        log(ph(25, "neus-facto frame profile"), f"one {FRAME_HW}^2 frame under torch.profiler: {activities:.0f} "
            f"device activities and {busy_ms:.2f} ms of device-busy time, i.e. the device idles "
            f"{1 - busy_ms / neus_frame_ms:.1%} of the unprofiled {neus_frame_ms:.1f} ms frame; K7 {k7_ms:.3f} ms "
            f"({k7_ms / busy_ms:.1%} of busy); matrix products {gemm_flops / 1e9:.1f} GFLOP; by class (ms/frame): "
            + ", ".join(f"{c} {tm:.3f}" for c, tm in sorted(classes.items(), key=lambda kv: -kv[1])))
        for name, tm in rows[:12]:
            print(f"    {tm:8.3f} ms/frame  {name[:110]}", flush=True)
    flat_eval = capture_flat_inputs(model, cams)
    del pipeline, state, model, frame

    # 20 (continued). K7's forward in every design at the frame chunk's own
    # inputs, then every design timed in turns there and at the check inputs
    k7_eval = []
    for c, (pos, table, kw) in enumerate(flat_eval):
        k7_eval.append(check_flat(ph(20, "K7 designs vs twin, eval chunk"), pos, table, kw,
                                  f"the middle chunk of a {FRAME_HW}^2 frame, call {c + 1}") + (pos.shape[0],))
    del flat_eval
    k7_sets = {f"check, {s} samples/ray": (*k7[f"fwd_{s}"], NEUS_RAYS * s) for s in NEUS_SAMPLES}
    k7_sets.update({f"eval chunk, call {c + 1}": rec for c, rec in enumerate(k7_eval)})
    k7_times = {label: time_flat(rec[1]) for label, rec in k7_sets.items()}
    log(ph(20, "K7 designs, timing"), f"on {card} (events: mean [two medians] / device ms); " + "; ".join(
        f"K7 at the {label} inputs (N={k7_sets[label][3]}, bound {k7_sets[label][2][0]:.4f} ms): " + ", ".join(
            f"{v} {ev:.4f} {[round(m, 4) for m in runs]} / {dev:.4f}" for v, (ev, runs, dev) in tm.items())
        for label, tm in k7_times.items()) + f"; default at F=2 and 4: {hg._pick_design(2)}")

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
    k6_bat = {"check": batch_ms(k6_bwd_check_fn), "trained": batch_ms(tr_fn)}
    log(ph(28, "K6 backward, trained state"), f"on {card}: trained state ({tb.tiles_x * 16}x{tb.tiles_y * 16}, "
        f"{int(tb.counts.sum())} entries in tiles, max {int(tb.counts.max())} per tile, walked {tr_walked:.0f}, "
        f"bound {tr_bound[0]:.4f} ms by {tr_bound[1]}): " + k6_bwd_line(tr_rel) + "; times (two medians each) "
        f"{k6_t['trained'][0]:.4f} ms {k6_t['trained'][1]} (device {k6_dev['trained']:.4f}, back to back "
        f"{k6_bat['trained']:.4f}); check inputs "
        f"(walked {k6_walked:.0f}, bound {k6_bounds[1][0]:.4f} ms): {k6_t['check'][0]:.4f} ms {k6_t['check'][1]} "
        f"(device {k6_dev['check']:.4f}, back to back {k6_bat['check']:.4f})")
    if max(tr_rel.values()) > K6_BWD_REL:
        raise AssertionError("K6 backward disagrees with its twin at the trained state")
    del k6_trained, m2, con, ch, op, tb, T, last, g_ch, tr_fn, k6_bwd_check_fn

    # 32. K6's forward, every design against the per-pixel one (bit-equal)
    # and the twin, and timed in turns, at the check inputs, with one long
    # tile and at a trained step's inputs
    check_k6_designs(ph(32, "K6 fwd designs"), "check inputs with non-finite entries",
                     *non_finite_inputs(*k6_inputs["check inputs"]))
    k6_recs = {label: time_k6(check_k6_designs(ph(32, "K6 fwd designs"), label, *args))
               for label, args in k6_inputs.items()}
    del k6_inputs
    log(ph(32, "K6 fwd designs, timing"), f"on {card} (events: mean [two medians] / device ms); "
        + "; ".join(k6_line(rec) for rec in k6_recs.values()) + f"; default: {rz.BLEND_FWD_DESIGNS[0]}")

    # 29. the per-lane gather (run_case, f4), every design on every variant
    lane = check_lane_designs(ph(29, "lane gather designs"), probe_args, gen)
    # 33. the gather-select (fused_gather, stage2) in both designs: bit-equal
    # at the probe variants and at edge inputs, and timed in turns
    select = check_select_designs(ph(33, "gather-select designs"), probe_args, gen)
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
            block_t[(exact, inputs)] = ev, dev, bat = time_block_designs(timing)
            lines.append(f"{label} at the {inputs} inputs: " + ", ".join(
                f"{d} {ev[d][0]:.4f} {ev[d][1]} / {dev[d]:.4f} / {bat[d]:.4f}" for d in hg.DESIGNS))
    block_n = {exact: inputs[0].shape[0] for exact, inputs in block_render.items()}
    del block_render
    log(ph(30, "K1 and K3 designs, timing"), f"on {card} (events: mean [two medians] / device ms / 50 back to "
        "back); "
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
    log(ph(31, "K1 bwd and K7 bwd designs, timing"), f"on {card} (events: mean [two medians] / device ms / 50 "
        "back to back); "
        + "; ".join(lines) + f"; default at F=2 and 4: {hg._pick_design(2)}")

    # 34-38. a scene on disk through the user's entry points: the train and
    # eval scripts with a resume, both gates, neus-facto through the trainer
    disk_root = tempfile.mkdtemp(prefix="chip_smoke_")
    jobs = {}
    try:
        scene = make_scene(ph(34, "scene"), disk_root)
        # the scenes of phases 59-60, made while phases 35-58 run
        jobs = {s: start_scene(disk_root, s) for s in ("semantic", "appearance")}
        disk = {"cli": cli_round_trip(ph(35, "CLI round trip"), scene, disk_root, card),
                "gate_nerfacto": gate_phase(ph(36, f"nerfacto, {CUT_GATE_STEPS} steps"), "nerfacto", scene,
                                            disk_root, card, NERFACTO_KERNELS, steps=CUT_GATE_STEPS),
                "gate_splatfacto": gate_phase(ph(37, f"splatfacto, {CUT_GATE_STEPS} steps"), "splatfacto", scene,
                                              disk_root, card, SPLAT_PATH_KERNELS, steps=CUT_GATE_STEPS),
                "neus_facto": neus_from_disk(ph(38, "neus-facto from disk"), scene, disk_root, card)}
        # 39-46. every camera type's rays and every sampling path on the card
        # against the CPU; distorted and masked captures: the four gates and
        # a mixed-resolution masked run through the resolution buckets
        raygen_phase(ph(39, "ray generation, card vs CPU"), card)
        sampling_phase(ph(40, "sampling, card vs CPU"), card)
        distorted = make_scene(ph(41, "scenes"), disk_root, "distorted")
        masked = make_scene(ph(41, "scenes"), disk_root, "masked")
        mixed = make_mixed_scene(ph(41, "scenes"), disk_root, masked)
        for i, (method, path) in enumerate(((m, p) for p in (distorted, masked) for m in ("nerfacto", "splatfacto"))):
            want = NERFACTO_KERNELS if method == "nerfacto" else SPLAT_PATH_KERNELS
            key = f"gate_{method}_{os.path.basename(path)}"
            steps = NERF_CUT_STEPS if method == "nerfacto" else CUT_GATE_STEPS
            disk[key] = gate_phase(ph(42 + i, f"{method} {os.path.basename(path)}, {steps} steps"), method,
                                   path, disk_root, card, want, steps=steps)
        disk["buckets"] = bucketed_run(ph(46, "nerfacto on masked buckets"), mixed, disk_root, card)

        # 47-52. splatfacto's options and methods
        options = options_and_methods(ph, card, scene, disk_root, disk)
        # 53-57. nerfacto-huge and nerfacto-big at full width, plain neus
        card_vs_cpu = big_methods_and_neus(ph, card, scene, disk_root, disk)
        # 58-60. depth-nerfacto, semantic-nerfw and phototourism
        nerfacto_family(ph, card, scene, disk_root, disk, jobs)
        # 61-63. tensorf, vanilla-nerf and mipnerf on blender
        k8_tensorf, double_backward = blender_methods(ph, card, disk_root, disk)
        # 64-66. instant-ngp and instant-ngp-bounded on blender; nerfacto's
        # sampling options
        instant_ngp_methods(ph, card, disk_root, disk)
        nerfacto_options = nerfacto_option_steps(ph(66, "nerfacto's sampling options, card vs cpu"), card)
        # 67. nerfacto with predict_normals: K3b and K1bb
        normals_checks = normals_phase(ph, card, scene, disk_root, disk)
    finally:
        for proc, _, _ in jobs.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(disk_root, ignore_errors=True)

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
        (ct, cdev, cbat), (rt, rdev, rbat) = block_t[(exact, "check")], block_t[(exact, "render")]
        r_errs, _, r_bnd = render_checks[exact]
        key = "hash_encode_block_exact" if exact else "hash_encode_block"
        e = entry(name, source, replaces, hash_launch[key], errs[default], ct[default][0], twin_ms, bnd,
                  design=default)
        e["device_ms"], e["batch_ms"] = cdev[default], cbat[default]
        e["designs"] = [dict(design=d, ms=ct[d][0], ms_runs=ct[d][1], device_ms=cdev[d], batch_ms=cbat[d],
                             max_abs_err=errs[d], render_ms=rt[d][0], render_ms_runs=rt[d][1],
                             render_device_ms=rdev[d], render_batch_ms=rbat[d],
                             render_max_abs_err=r_errs[d]) for d in hg.DESIGNS]
        e["render"] = dict(n=int(block_n[exact]), ms=rt[default][0], device_ms=rdev[default], batch_ms=rbat[default],
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
              0.0, t["k5"], t["k5_twin"], k5_recs["check"]["bound"], t["k5_sort"], design="bucketed"),
        entry("blend_saturating (K6 fwd)", gs_source, "nerfstudio_tpu/ops/gsplat/rasterize.py:94",
              splat_launches["blend_saturating"], k6_err, t["k6"], t["k6_twin"], k6_bounds[0],
              design=rz.BLEND_FWD_DESIGNS[0]),
        entry("blend_saturating_bwd (K6 bwd)", gs_source, "nerfstudio_tpu/ops/gsplat/rasterize.py:142",
              splat_launches["blend_saturating_bwd"], k6_bwd_err, k6_t["check"][0], t["k6_bwd_twin"], k6_bounds[1],
              design="block-reduced"),
    ]
    # K4 and K6 forward: device ms per kernel record (the profiler may drop
    # records; device_ms divides by the calls made), the sum over calls too
    for e, k in ((kernels[3], "fwd"), (kernels[4], "bwd")):
        e.update(device_ms=k4_rec[k][0], records=k4_rec[k][1], profiler_sum_ms=k4_dev[k], batch_ms=k4_batch[k])
    # K6 forward: every design at the three inputs of phase 32, the
    # per-pixel design's launches (0 on the main path)
    kernels[-2].update(
        per_pixel_launches=splat_launches["blend_saturating_per_pixel"],
        device_ms=k6_recs["check inputs"]["times"][rz.BLEND_FWD_DESIGNS[0]]["record_ms"],
        designs=[dict(design=d, inputs=[dict(inputs=label, **r["times"][d], max_abs_err=r["max_abs_err"][d],
                                             rel_err=r["rel"][d], bit_equal_to_per_pixel=r["bit_equal"][d])
                                        for label, r in k6_recs.items()]) for d in rz.BLEND_FWD_DESIGNS],
        inputs=[dict(inputs=label, entries=r["entries"], per_tile_max=r["per_tile_max"], walked=r["walked"],
                     bound_ms=r["bound"][0], bound_by=r["bound"][1], cull_share=r["cull_share"],
                     pairs_tested=r["pairs_tested"], saturated=r["saturated"], clocks=r["clocks"])
                for label, r in k6_recs.items()])
    # K6 backward: the check inputs' walk, and the trained state's
    kernels[-1].update(
        walked=k6_walked, device_ms=k6_dev["check"], batch_ms=k6_bat["check"],
        trained={"walked": tr_walked, "ms": k6_t["trained"][0], "device_ms": k6_dev["trained"],
                 "batch_ms": k6_bat["trained"],
                 "bound_ms": tr_bound[0], "bound_by": tr_bound[1], "max_abs_err": tr_err})
    # K5: the launches of its default design, every design and yardstick at
    # the three inputs of phase 14
    k5_entry = next(e for e in kernels if e["name"].startswith("tile_bin"))
    k5_entry.update(bucketed_launches=splat_launches["tile_bin_bucketed"],
                    device_ms=k5_recs["check"]["times"]["bucketed"]["device_ms"],
                    inputs=[dict(inputs=label, bound_ms=r["bound"][0], bound_by=r["bound"][1],
                                 **{k: v for k, v in r.items() if k != "bound"}) for label, r in k5_recs.items()])
    big = f"fwd_{NEUS_SAMPLES[0]}"
    k7_errs = [rec[0][flat_default] for rec in k7_sets.values()]
    kernels.append(entry("hash_encode_flat (K7 fwd), 256 samples/ray", source, "nerfstudio_tpu/ops/hash_grid.py:63",
                         neus_launches["hash_encode_flat"], max(k7_errs), t["k7_" + big], t["k7_" + big + "_twin"],
                         k7[big][2], design=flat_default))
    # K7 fwd: every design at the check and eval-chunk inputs, the frame
    kernels[-1].update(
        device_ms=k7_times[f"check, {NEUS_SAMPLES[0]} samples/ray"][flat_default][2],
        eval_launches=eval_launches["hash_encode_flat"],
        designs=[dict(design=v, inputs=[dict(inputs=label, n=k7_sets[label][3], ms=tm[v][0], ms_runs=tm[v][1],
                                             device_ms=tm[v][2], max_abs_err=k7_sets[label][0][v])
                                        for label, tm in k7_times.items()]) for v in hg.DESIGNS],
        inputs=[dict(inputs=label, n=rec[3], bound_ms=rec[2][0], bound_by=rec[2][1]) for label, rec in k7_sets.items()],
        frame=dict(ms=neus_frame_ms, **(neus_frame_prof or {}),
                   designs={v: dict(ms=ms, ms_runs=runs) for v, (ms, runs) in neus_frames.items()}))
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
                          device_ms=r["designs"][default]["device_ms"], batch_ms=r["designs"][default]["batch_ms"],
                          bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], scatter_alone=r["scatter_alone"],
                          designs={d: dict(ms=x["ms"], device_ms=x["device_ms"], batch_ms=x["batch_ms"])
                                   for d, x in r["designs"].items()})
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
        if (k, main_v) in select:  # fused_gather, stage2: both designs at each variant (phase 33)
            e["design"] = gp.GATHER_SELECT_DESIGNS[0]
            e["device_ms"] = next(d["device_ms"] for d in select[(k, main_v)]["designs"] if d["design"] == e["design"])
            e["designs"] = [dict(variant=v, **r) for (kk, v), r in select.items() if kk == k]
        kernels.append(e)
    # K4's backward with the viewmat gradient: launches on the options run
    # (phase 52), its times at 1M slots, every input set of phase 47
    k4v_recs, k4v_times = options["k4v_recs"], options["k4v_times"]
    kv = k4v_times[1]
    kernels.append(entry("project_gaussians_bwd_viewmat (K4 bwd with the viewmat gradient)", gs_source,
                         "nerfstudio_tpu/ops/gsplat/projection.py:39",
                         disk["options"]["launches"]["project_gaussians_bwd_viewmat"],
                         max(r["max_abs_err"] for r in k4v_recs), kv["viewmat"]["ms"], kv["plain_ms"], kv["bound"],
                         design="block partials, one-block sum"))
    kernels[-1].update(device_ms=kv["viewmat"]["device_ms"], batch_ms=kv["viewmat"]["batch_ms"], checks=k4v_recs,
                       times=[dict(t, bound_ms=t["bound"][0], bound_by=t["bound"][1],
                                   default_bound_ms=t["default_bound"][0]) for t in k4v_times],
                       k8_card_vs_cpu=options["k8"], option_steps_card_vs_cpu=options["option_steps"],
                       mcmc_refine_card_vs_cpu=options["mcmc_refine"])
    for t in kernels[-1]["times"]:
        del t["bound"], t["default_bound"]
    # each kernel's launches on the from-disk paths (phases 35-38 and 42-46;
    # the gates' counts include their eval renders) and K5 at the frame above its
    # bucketed design's tile limit (phase 14)
    launch_key = {"hash_encode_block (K1 fwd)": "hash_encode_block", "hash_encode_block_exact (K3)":
                  "hash_encode_block_exact", "project_gaussians (K4 fwd)": "project_gaussians",
                  "project_gaussians_bwd (K4 bwd)": "project_gaussians_bwd", "tile_bin (K5)": "tile_bin",
                  "project_gaussians_bwd_viewmat (K4 bwd with the viewmat gradient)": "project_gaussians_bwd_viewmat",
                  "blend_saturating (K6 fwd)": "blend_saturating", "blend_saturating_bwd (K6 bwd)":
                  "blend_saturating_bwd"}
    for e in kernels:
        key = launch_key.get(e["name"]) or next(
            (k for k in ("hash_encode_block_bwd", "hash_encode_flat_bwd", "hash_encode_flat")
             if e["name"].startswith(k + " ")), None)
        if key is not None:
            e["disk_launches"] = {path: rec["launches"].get(key, 0) for path, rec in disk.items()}
            # against the twin at each path's own inputs (phases 36-38, 42-45)
            e["disk_max_abs_err"] = {path: rec["max_abs_err"][key] for path, rec in disk.items()
                                     if key in rec.get("max_abs_err", {})}
    k5_entry["above_limit"] = k5_above
    # K1 forward and backward and K3 at nerfacto-huge's, nerfacto-big's and
    # phototourism's trained state (phases 54-55, 60): every call of one
    # step, one eval chunk
    for method in ("nerfacto-huge", "nerfacto-big", FAMILY_TIMED):
        recs = disk[f"gate_{method}"]["kernels"]
        for e, kernel in ((kernels[0], "K1 fwd"), (kernels[1], "K3"), (kernels[2], "K1 bwd")):
            e.setdefault("trained_shapes", {})[method] = [r for r in recs if r["kernel"] == kernel]
    kernels[0]["huge_step_card_vs_cpu"] = card_vs_cpu["huge_step"]
    # the nerfacto family's trained steps on the card against the CPU twins,
    # the hash grid's share of their profiled steps (phases 58-60)
    kernels[0]["family"] = {method: dict(disk[f"gate_{method}"]["after"],
                                         hash_share=disk[f"gate_{method}"].get("hash_share"))
                            for method, _, _ in FAMILY}
    # the Blender-protocol methods (phases 61-63), none of which launches a
    # hand-written kernel: their checks at the trained state, and K8 (plain
    # PyTorch, no kernel of its own) at tensorf's step, beside the bilateral
    # grid's card-vs-CPU record of phase 48
    kernels[0]["blender_methods"] = {method: dict(disk[f"gate_{method}"]["after"], idle=disk[f"gate_{method}"]["idle"])
                                     for method, _ in BLENDER_RUNS}
    kernels[0]["double_backward_gap"] = double_backward  # K1 vs its twin; K7, K4, K6 refused, first order vs plain
    # instant-ngp and its bounded variant (phases 64-65): K1 forward and
    # backward at one step's calls and K3 at one eval chunk, K1 at one
    # whole-grid refresh, the checks at the trained state; nerfacto's
    # sampling options card vs CPU (phase 66)
    for method, _ in NGP_RUNS:
        rec = disk[f"gate_{method}"]
        for e, kernel in ((kernels[0], "K1 fwd"), (kernels[1], "K3"), (kernels[2], "K1 bwd")):
            e.setdefault("trained_shapes", {})[method] = [r for r in rec["kernels"] if r["kernel"] == kernel]
        kernels[0]["trained_shapes"][method].append(rec["after"]["refresh"])
    kernels[0]["instant_ngp"] = {method: dict({k: v for k, v in disk[f"gate_{method}"]["after"].items()
                                               if k != "refresh"}, idle=disk[f"gate_{method}"]["idle"],
                                              hash_share=disk[f"gate_{method}"].get("hash_share"))
                                 for method, _ in NGP_RUNS}
    kernels[0]["nerfacto_options"] = nerfacto_options
    kernels[-1]["k8_tensorf_step"] = k8_tensorf
    # K3b and K1bb (phase 67): their launches in nerfacto-with-normals' run
    # (training and eval, counted from 0 just before it; the per-thread
    # design's count is 0 there), the check inputs' records (every design's
    # times and errors, the bound) and the trained state's
    normals = disk["gate_nerfacto_normals"]
    for key, kname, label, replaces in (
            ("K3b", "hash_encode_block_exact_bwd", "hash_encode_block_exact_bwd (K3b, K3's position gradient)",
             "nerfstudio_tpu/ops/hash_grid.py:696"),
            ("K1bb", "hash_encode_block_bwd_bwd", "hash_encode_block_bwd_bwd (K1bb, K1's backward differentiated)",
             "nerfstudio_tpu/ops/hash_grid.py:439")):
        first, trained = normals_checks[key][0], normals["after"]["kernels"][key]
        e = entry(label, source, replaces, normals["launches"][kname],
                  max(r["max_abs_err"] for r in normals_checks[key] + trained), first["ms"], first["plain_ms"],
                  (first["bound_ms"], first["bound_by"]), design=first["design"])
        e.update(device_ms=first["device_ms"], batch_ms=first["batch_ms"], checks=normals_checks[key],
                 trained=trained, launches_per_train_step=normals["gate_launches"]["train"][kname] / normals["steps"],
                 eval_launches=normals["gate_launches"]["eval"][kname],
                 per_thread_launches=normals["launches"]["hash_encode_normals_per_thread"],
                 designs=[dict(design=d, inputs=[dict(inputs=r["inputs"], n=r["n"], **r["designs"][d])
                                                 for r in normals_checks[key] + trained]) for d in hg.DESIGNS])
        kernels.append(e)
    kernels[0]["nerfacto_normals"] = dict({k: v for k, v in normals["after"].items() if k != "kernels"},
                                          idle=normals["idle"], loss=normals["loss"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
