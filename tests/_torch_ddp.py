"""Rank workers for the port's data-parallel tests
(tests/test_torch_ddp_*.py): each runs in a process of its own, started by
``nerfstudio_torch.parallel.mesh.launch`` with the ``spawn`` method, and
saves what it computed to ``OUT/rank{r}.pt``. Imports torch and the port
only (no JAX), so that a rank starts quickly."""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Any, Dict, List

import torch

from nerfstudio_torch.parallel import mesh

_CALLS = itertools.count()


def run_ranks(fn, args, world: int, tmp: Path) -> List[Dict[str, Any]]:
    """``fn(out, *args)`` on ``world`` gloo ranks on the CPU (a ``file://``
    store under ``tmp``: no port to collide with another test process), or
    in this process without a group for one rank; each rank's saved dict."""
    out = Path(tmp) / f"ranks{next(_CALLS)}"
    out.mkdir(parents=True)
    mesh.launch(fn, (out,) + tuple(args), devices=["cpu"] * world, backend="gloo",
                dist_url=f"file://{out / 'store'}", timeout_s=300.0)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def save(out: Path, result: Dict[str, Any]) -> None:
    torch.save(result, Path(out) / f"rank{mesh.rank()}.pt")


def float32_mlps(model) -> None:
    """Every MLP and field head of ``model`` computing in float32."""
    from nerfstudio_torch.field_components.field_heads import FieldHead
    from nerfstudio_torch.field_components.mlp import MLP

    for m in model.modules():
        if isinstance(m, (MLP, FieldHead)):
            m.dtype = torch.float32


def params_and_grads(named) -> Dict[str, Any]:
    """{name: (value, gradient or None)}, detached copies."""
    return {n: (p.detach().clone(), None if p.grad is None else p.grad.detach().clone()) for n, p in named}


# --------------------------------------------------------------------------


def collectives(out: Path) -> None:
    """``all_reduce_grads`` on parameters whose gradients differ by rank:
    one on every rank, one on rank 0 alone, one on none, one float64 (a
    second buffer); ``shard_rays`` of a batch tree; ``rand_rays`` inside
    and outside ``ray_shard``; ``all_reduce_`` (sum, max) and
    ``global_means``."""
    r = mesh.rank()
    ps = [torch.zeros(3, 2), torch.zeros(4), torch.zeros(2), torch.zeros(3, dtype=torch.float64)]
    ps[0].grad = torch.arange(6.0).view(3, 2) * (r + 1)
    ps[1].grad = torch.full((4,), 2.0) if r == 0 else None
    ps[3].grad = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64) * (r + 1)
    mesh.all_reduce_grads(ps)
    batch = {"image": torch.arange(16.0).view(8, 2), "parts": (torch.arange(8), None)}
    g = torch.Generator().manual_seed(3)
    with mesh.ray_shard():
        sharded = mesh.rand_rays((4, 1), g, "cpu")
    plain = mesh.rand_rays((4, 1), g, "cpu")
    summed = mesh.all_reduce_(torch.tensor([1.0, float(r)]))
    peak = mesh.all_reduce_(torch.tensor([float(r), -float(r)]), "max")
    means = mesh.global_means({"a": torch.tensor(float(r)), "b": torch.tensor(2.0)})
    save(out, dict(grads=[None if p.grad is None else p.grad.clone() for p in ps], shard=mesh.shard_rays(batch),
                   sharded=sharded, plain=plain, summed=summed, peak=peak, means=means, world=mesh.world_size()))


def nerfacto_step(out: Path, config, payload, step: int, cells, jitter, draws, kwargs) -> None:
    """The factory-built pipeline of ``config`` restored from ``payload``
    (``trainer_checkpoint_from_jax``) at ``step``, its MLPs in float32:
    the occupancy hook with (cells, jitter), one train step with the global
    ``draws``; the global metrics, every parameter and gradient after it,
    the optimizer's state, the grid."""
    from nerfstudio_torch.engine.trainer import restore_train_state
    from nerfstudio_torch.pipelines.factory import build_pipeline

    pipe, state, config = build_pipeline(config)
    restore_train_state(pipe, state, payload)
    state.step = step
    float32_mlps(pipe.model)
    pipe.aux_update_fn(state, step, cells=cells, jitter=jitter)
    metrics = pipe.global_metrics(pipe.train_step(state, draws=draws, **kwargs))
    save(out, dict(metrics={k: float(v) for k, v in metrics.items()},
                   params=params_and_grads(pipe.model.named_parameters()), optimizer=state.optimizer.state_dict(),
                   densities=state.aux.densities.clone(), binary=state.aux.binary.clone()))


def trainer_steps(out: Path, config, steps: int) -> None:
    """``steps`` iterations of the factory-built trainer of ``config``, its
    MLPs in float32 (the aux hook, then the step, on the trainer's
    generator): each step's global metrics, then the trainer's whole
    checkpoint payload."""
    from nerfstudio_torch.pipelines.factory import build_trainer

    trainer = build_trainer(config)
    float32_mlps(trainer.pipeline.model)
    losses = []
    for step in range(steps):
        metrics = trainer.pipeline.global_metrics(trainer.train_iteration(step))
        losses.append({k: float(v) for k, v in metrics.items()})
    save(out, dict(metrics=losses, payload=trainer.checkpoint()))


def trainer_run(out: Path, config) -> None:
    """``Trainer.train`` of ``config`` (its saves and eval cadence on rank
    0), then the trainer's whole checkpoint payload on each rank."""
    from nerfstudio_torch.pipelines.factory import build_trainer

    trainer = build_trainer(config)
    trainer.train()
    save(out, dict(payload=trainer.checkpoint()))


def splat_step(out: Path, config, state_arrays, cameras, noise, means_lr: float, transmittance_eps: float) -> None:
    """One splat step of rank r on camera r of ``cameras`` ((c2w, K, gt,
    background, cam_idx) each) from ``state_arrays`` (params, aux, moments,
    step of ``splat_state_from_jax``), with the shared MCMC ``noise``, K6's
    twin stopping a pixel below ``transmittance_eps``: the global metrics,
    every array, gradient, moment and count, the aux."""
    from nerfstudio_torch.models.splatfacto import SplatfactoModel
    from nerfstudio_torch.ops.gsplat import rasterize
    from nerfstudio_torch.pipelines.splat_pipeline import SplatPipeline

    rasterize.TRANSMITTANCE_EPS = transmittance_eps

    c2w, K, gt, bg, cam_idx = cameras[mesh.rank()]
    h, w = gt.shape[:2]
    pipeline = SplatPipeline(None, SplatfactoModel(config, scene_scale=1.5))
    st = pipeline.state_from(*state_arrays)
    metrics = mesh.global_means(pipeline.train_step(st, c2w, K, gt, bg, w, h, 3, cam_idx=cam_idx, noise=noise,
                                                    means_lr=means_lr))
    moments = {k: {s: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for s, v in st.optimizer.optimizer.state[p].items()} for k, p in st.params.items()}
    save(out, dict(metrics={k: float(v) for k, v in metrics.items()}, params=params_and_grads(st.params.items()),
                   moments=moments, aux={k: getattr(st.aux, k).clone() for k in ("alive", "grad_accum", "grad_count",
                                                                                 "max_radii")}, step=st.step))


def splat_train(out: Path, config, steps: int) -> None:
    """``SplatPipeline.train`` of the factory-built splat pipeline of
    ``config`` for ``steps`` steps on the generator seeded with the config's
    seed: the last metrics and the whole state (gaussians, Adam state,
    aux, step, generator)."""
    from nerfstudio_torch.engine.trainer import aux_state
    from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline

    pipeline, state = build_splat_pipeline(config)
    gen = torch.Generator().manual_seed(config.seed)
    state, metrics = pipeline.train(state, steps, gen)
    save(out, dict(metrics={k: float(v) for k, v in metrics.items()},
                   state=dict(params={k: v.detach().clone() for k, v in state.params.items()},
                              optimizer=state.optimizer.state_dict(), aux=aux_state(state.aux), step=state.step,
                              generator=gen.get_state())))
