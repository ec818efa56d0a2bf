#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nerfstudio_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``nerfstudio_torch/csrc``, holds each
against its plain PyTorch twin at the shapes the nerfacto render and
training give it (K1 forward, K3, K1 backward against a float64 run of its
twin), then drives the port's two paths at the shipped width from random
weights: the render (four 512x512 frames through ``render_camera``, the
kernels launched once per chunk; a 128x128 frame on the card against the
CPU twins) and the training step (bench.py's setup: steps 256-259, then
12 warm-up and 50 timed steady-state steps from step 6000, with the kernels'
launches checked per step; a torch.profiler breakdown of three steady
steps; one step on the card against the CPU twins). Times the kernels,
their twins, a frame and the training rays/s.

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
    from nerfstudio_torch.ops import hash_grid as hg

    pos, table = kernel_inputs(n, num_levels, log2_t, features, min_res, max_res, "cuda", gen)
    kw = dict(min_res=min_res, max_res=max_res, hash_table_size=2**log2_t)
    twin = hg._block_exact_twin if exact else hg._block_stochastic_twin
    with torch.no_grad():
        out = hg._block_kernel(pos, table, exact=exact, **kw)
        ref = twin(pos, table, **kw)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    max_abs = float(diff.max())
    flipped = int((diff.amax(dim=-1) > KERNEL_FLIP).sum())
    ok = torch.isfinite(out).all() and max_abs <= KERNEL_MAX_ABS and flipped == 0
    log(name, f"N={n} L={num_levels} F={features} T=2^{log2_t} max_res={max_res}: "
        f"max |kernel - twin| = {max_abs:.3g} (limit {KERNEL_MAX_ABS}), samples off by > {KERNEL_FLIP}: {flipped}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    timing = dict(
        kernel=lambda: hg._block_kernel(pos, table, exact=exact, **kw),
        twin=lambda: twin(pos, table, **kw),
    )
    return max_abs, timing


U32 = 2.0**-24  # float32 unit roundoff


def table_grad_bound(pos, table, g, scales, kw):
    """Per-entry limit on |kernel - float64 twin| of the table gradient: a
    float32 sum of k terms in any order is off by at most (k-1) * u * sum|t|
    (u = 2^-24), plus the four roundings of each term w8*g*scale. sum|t| is the
    float64 twin on |g| (weights and scales are >= 0); k counts each entry's
    terms from the geometry."""
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
    return max_abs, timing


# --------------------------------------------------------------------------
# the slice: nerfacto eval render


def orbit_cameras(n: int, hw: int, device):
    from nerfstudio_torch.cameras.cameras import Cameras

    c2w = np.zeros((n, 3, 4), np.float32)
    for i, t in enumerate(2 * np.pi * np.arange(n) / n):
        pos = np.array([2 * np.cos(t), 2 * np.sin(t), 1.0])
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
    occupancy update, and no K3. Returns the last step's metrics."""
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
                    "hash_encode_block_bwd": 1 + bool(kwargs["update_proposals"])}
            got = {k: hg.launch_counts[k] - before[k] for k in want}
            if got != want:
                raise AssertionError(f"step {step} ({kwargs}): launches {got}, expected {want}")
    return metrics


def profile_steps(cfg, pipeline, state, hook, start, gen):
    """Device time by kernel over PROFILED_STEPS steady steps
    (torch.profiler). Returns (rows (name, ms per step) by time, device-busy
    ms per step (the union of the kernels' intervals), device activities per
    step), or None when the profiler saw no device activity. The profiler
    slows the host, so the caller sets the busy time against an unprofiled
    step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_steps(cfg, pipeline, state, hook, range(start, start + PROFILED_STEPS), gen)
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
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
    rows = sorted(((n, t / PROFILED_STEPS) for n, t in by_name.items()), key=lambda r: -r[1])
    return rows, busy_us / 1e3 / PROFILED_STEPS, len(spans) / PROFILED_STEPS


KERNEL_CLASSES = (  # first match wins, on the lower-cased kernel name
    ("hash-grid kernels", ("block_encode",)),
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nerfstudio_torch.models.base_model import render_camera
    from nerfstudio_torch.ops import cuda_build
    from nerfstudio_torch.ops import hash_grid as hg

    n_phases = 12
    ph = lambda i, name: f"{i}/{n_phases} {name}"  # noqa: E731

    # 1. card
    card = card_line()
    print(card, flush=True)
    log(ph(1, "card"), f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib_path, nvcc_s = cuda_build.build("hash_grid")
    hg._kernel_library()
    log(ph(2, "build"), f"{lib_path.name}: nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # 3-6. kernels vs twins at the slices' shapes: K1 (the proposal net of the
    # render), K3 (the field at eval), K1 bwd (the field at steady state:
    # P=2 on levels 0, 2, 4, 6; the proposal net with live proposals)
    k1_err, k1_timing = check_kernel(ph(3, "K1 vs twin"), False, 2_097_152, 5, 17, 2, 16, 256, gen)
    k3_err, k3_timing = check_kernel(ph(4, "K3 vs twin"), True, 1_048_576, 8, 19, 4, 16, 2048, gen)
    bwd_field_err, bwd_field_timing = check_kernel_bwd(
        ph(5, "K1 bwd vs twin, field"), TRAIN_RAYS * 32, 8, 19, 4, 16, 2048, (2.0, 0.0) * 4, gen)
    bwd_prop_err, bwd_prop_timing = check_kernel_bwd(
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
    if render_launches != {"hash_encode_block": want, "hash_encode_block_exact": want, "hash_encode_block_bwd": 0}:
        raise AssertionError(f"kernel launches {render_launches}, expected {want} of each forward (one per chunk)")
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
        rows, busy_ms, activities = prof
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
    frame_ms = median_ms(lambda: render_camera(model, None, cams, 0, CHUNK, aux=grid), runs=10, warmup=2)
    log(ph(12, "timing"), f"on {card}: K1 {times['k1']:.3f} ms (twin {times['k1_twin']:.3f} ms), "
        f"K3 {times['k3']:.3f} ms (twin {times['k3_twin']:.3f} ms), "
        f"K1 bwd field {times['bwd_field']:.3f} ms (twin {times['bwd_field_twin']:.3f} ms), "
        f"K1 bwd proposal {times['bwd_prop']:.3f} ms (twin {times['bwd_prop_twin']:.3f} ms), "
        f"{FRAME_HW}^2 frame {frame_ms:.1f} ms = {FRAME_HW * FRAME_HW / (frame_ms / 1e3):,.0f} rays/s, "
        f"training {rays_per_s:,.0f} rays/s")

    source = "nerfstudio_torch/csrc/hash_grid.cu"
    print(json.dumps({"kernels": [
        {"name": "hash_encode_block (K1 fwd)", "route": "cuda", "source": source,
         "replaces": "nerfstudio_tpu/ops/hash_grid.py:352",
         "launches": render_launches["hash_encode_block"] + train_launches["hash_encode_block"],
         "max_abs_err": k1_err, "ms": times["k1"], "plain_ms": times["k1_twin"]},
        {"name": "hash_encode_block_exact (K3)", "route": "cuda", "source": source,
         "replaces": "nerfstudio_tpu/ops/hash_grid.py:696",
         "launches": render_launches["hash_encode_block_exact"] + train_launches["hash_encode_block_exact"],
         "max_abs_err": k3_err, "ms": times["k3"], "plain_ms": times["k3_twin"]},
        {"name": "hash_encode_block_bwd (K1 bwd + K2), field shape", "route": "cuda", "source": source,
         "replaces": "nerfstudio_tpu/ops/hash_grid.py:439",
         "launches": render_launches["hash_encode_block_bwd"] + train_launches["hash_encode_block_bwd"],
         "max_abs_err": max(bwd_field_err, bwd_prop_err), "ms": times["bwd_field"],
         "plain_ms": times["bwd_field_twin"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
