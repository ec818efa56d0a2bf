"""Ray samplers (counterpart of ``nerfstudio_tpu/model_components/ray_samplers.py``).

Samplers are plain callables of (RayBundle, generator) that return
fixed-shape RaySamples. Randomness enters only through an explicit
``torch.Generator``, or as the uniforms themselves (``uniforms=``), which is
how a test hands in the reference's draws; with neither, the samplers take
the deterministic midpoints of the eval path. The reference's
comparison-count ``searchsorted_batched`` maps to
``torch.searchsorted(side="left")`` and its one-hot ``take_last_axis`` to
``torch.gather``."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from nerfstudio_torch.core.rays import RayBundle, RaySamples


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 ``jnp.linspace``, bit for bit: ``start*(1-s) + stop*s`` with
    ``s = i/(num-1)``, and ``stop`` itself as the last point."""
    f32 = dict(dtype=torch.float32, device=device)
    start_t = torch.tensor(start, **f32)
    stop_t = torch.tensor(stop, **f32)
    if num == 1:
        return start_t.reshape(1)
    step = torch.arange(num - 1, **f32) / (num - 1)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t.reshape(1)])


# ---------------------------------------------------------------------------
# Spaced samplers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpacedSampler:
    """Stratified sampling under a spacing warp (reference ray_samplers.py:31-78)."""

    num_samples: int
    spacing_fn: Callable[[torch.Tensor], torch.Tensor]
    spacing_fn_inv: Callable[[torch.Tensor], torch.Tensor]
    train_stratified: bool = True
    single_jitter: bool = False

    def __call__(
        self,
        ray_bundle: RayBundle,
        generator: Optional[torch.Generator] = None,
        num_samples: Optional[int] = None,
        uniforms: Optional[torch.Tensor] = None,
    ) -> RaySamples:
        """``uniforms``: the jitter in [0, 1), (..., 1) with ``single_jitter``
        else (..., n+1); drawn from ``generator`` when not given."""
        n = num_samples or self.num_samples
        num_rays = ray_bundle.shape
        device = ray_bundle.origins.device
        bins = linspace(0.0, 1.0, n + 1, device).expand(num_rays + (n + 1,))

        jitter_shape = num_rays + ((1,) if self.single_jitter else (n + 1,))
        if self.train_stratified and generator is not None and uniforms is None:
            uniforms = torch.rand(jitter_shape, generator=generator, device=device)
        if self.train_stratified and uniforms is not None:
            t_rand = uniforms.reshape(jitter_shape)
            bin_centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
            bin_upper = torch.cat([bin_centers, bins[..., -1:]], dim=-1)
            bin_lower = torch.cat([bins[..., :1], bin_centers], dim=-1)
            bins = bin_lower + (bin_upper - bin_lower) * t_rand

        s_near = self.spacing_fn(ray_bundle.nears)  # (..., 1)
        s_far = self.spacing_fn(ray_bundle.fars)

        def spacing_to_euclidean(s):
            return self.spacing_fn_inv(s * s_far[..., 0:1] + (1 - s) * s_near[..., 0:1])

        euclidean_bins = spacing_to_euclidean(bins)
        return ray_bundle.get_ray_samples(
            bin_starts=euclidean_bins[..., :-1, None],
            bin_ends=euclidean_bins[..., 1:, None],
            spacing_starts=bins[..., :-1, None],
            spacing_ends=bins[..., 1:, None],
            spacing_to_euclidean_fn=spacing_to_euclidean,
        )


def UniformSampler(num_samples: int, train_stratified=True, single_jitter=False) -> SpacedSampler:
    """(reference :81-83)"""
    return SpacedSampler(num_samples, lambda x: x, lambda x: x, train_stratified, single_jitter)


def UniformLinDispPiecewiseSampler(num_samples: int, train_stratified=True, single_jitter=False) -> SpacedSampler:
    """Half uniform up to distance 1, half linear in disparity beyond (reference :101-110)."""
    return SpacedSampler(
        num_samples,
        lambda x: torch.where(x < 1, x / 2, 1 - 1 / (2 * x)),
        lambda x: torch.where(x < 0.5, 2 * x, 1 / (2 - 2 * x)),
        train_stratified,
        single_jitter,
    )


# ---------------------------------------------------------------------------
# PDF sampler
# ---------------------------------------------------------------------------


def _sorted_interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interp of (xp, fp) at x over the last axis (reference :132-150)."""
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), side="left")
    n = xp.shape[-1]
    below = torch.clamp(idx - 1, 0, n - 1)
    above = torch.clamp(idx, 0, n - 1)
    xp0, xp1 = torch.gather(xp, -1, below), torch.gather(xp, -1, above)
    fp0, fp1 = torch.gather(fp, -1, below), torch.gather(fp, -1, above)
    denom = xp1 - xp0
    ok = denom > 1e-10
    t = torch.where(ok, (x - xp0) / torch.where(ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    return fp0 + t * (fp1 - fp0)


@dataclasses.dataclass(frozen=True)
class PDFSampler:
    """Inverse-CDF importance sampling from previous weights (reference
    :153-224). With ``include_original`` the new bin edges are merged with
    the previous ones, sorted, before the gradient stop (:212-213)."""

    num_samples: int
    train_stratified: bool = True
    single_jitter: bool = False
    include_original: bool = False
    histogram_padding: float = 0.01

    def __call__(
        self,
        ray_bundle: RayBundle,
        ray_samples: RaySamples,
        weights: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        num_samples: Optional[int] = None,
        uniforms: Optional[torch.Tensor] = None,
    ) -> RaySamples:
        """``uniforms``: the jitter in [0, 1), (..., 1) with ``single_jitter``
        else (..., n+1); drawn from ``generator`` when not given."""
        n = num_samples or self.num_samples
        num_bins = n + 1
        w = weights[..., 0] + self.histogram_padding  # (..., S)

        # degenerate-histogram guard (reference :176-180)
        w_sum = torch.sum(w, dim=-1, keepdim=True)
        padding = torch.clamp_min(1e-5 - w_sum, 0.0)
        w = w + padding / w.shape[-1]
        w_sum = w_sum + padding

        pdf = w / w_sum
        cdf = torch.clamp_max(torch.cumsum(pdf[..., :-1], dim=-1), 1.0)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)

        lead = tuple(cdf.shape[:-1])
        u = linspace(0.0, 1.0 - (1.0 / num_bins), num_bins, cdf.device)
        jitter_shape = lead + ((1,) if self.single_jitter else (num_bins,))
        if self.train_stratified and generator is not None and uniforms is None:
            uniforms = torch.rand(jitter_shape, generator=generator, device=cdf.device)
        if self.train_stratified and uniforms is not None:
            u = u + uniforms.reshape(jitter_shape) / num_bins
        else:
            u = u + 1.0 / (2 * num_bins)
        u = u.expand(lead + (num_bins,))

        assert ray_samples.spacing_starts is not None and ray_samples.spacing_ends is not None
        assert ray_samples.spacing_to_euclidean_fn is not None
        existing_bins = torch.cat(
            [ray_samples.spacing_starts[..., 0], ray_samples.spacing_ends[..., -1:, 0]], dim=-1
        )  # (..., S+1)

        bins = _sorted_interp(u, cdf, existing_bins)
        if self.include_original:
            bins = torch.sort(torch.cat([existing_bins, bins], dim=-1), dim=-1).values
        bins = bins.detach()
        euclidean_bins = ray_samples.spacing_to_euclidean_fn(bins)
        return ray_bundle.get_ray_samples(
            bin_starts=euclidean_bins[..., :-1, None],
            bin_ends=euclidean_bins[..., 1:, None],
            spacing_starts=bins[..., :-1, None],
            spacing_ends=bins[..., 1:, None],
            spacing_to_euclidean_fn=ray_samples.spacing_to_euclidean_fn,
        )


# ---------------------------------------------------------------------------
# Proposal sampler (nerfacto)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplerUniforms:
    """The proposal sampler's draws, each in [0, 1): the probe jitter and
    one jitter per round (proposal rounds, then the field's), each
    (num_rays, 1) with ``single_jitter``. A None entry is drawn from the
    generator."""

    probes: Optional[torch.Tensor]
    rounds: Tuple[Optional[torch.Tensor], ...]


@dataclasses.dataclass(frozen=True)
class ProposalNetworkSampler:
    """Hierarchical proposal sampling (reference :226-322).

    The first round's samples come from ``initial_sampler``, by default
    ``UniformLinDispPiecewiseSampler`` (neus-facto passes a
    ``UniformSampler``). ``initial_weights_fn`` (probe RaySamples -> (R, P, 1) weights) replaces
    the first proposal round with a net-free weight source such as the
    occupancy grid; its probes use ``num_initial_probes`` samples. The
    proposal weight anneal and the proposal-gradient gate are explicit
    arguments."""

    num_proposal_samples_per_ray: Tuple[int, ...] = (64,)
    num_nerf_samples_per_ray: int = 32
    num_proposal_network_iterations: int = 2
    single_jitter: bool = True
    initial_weights_fn: Optional[Callable[[RaySamples], torch.Tensor]] = None
    num_initial_probes: int = 192
    initial_sampler: Optional[SpacedSampler] = None

    def __post_init__(self):
        if self.num_proposal_network_iterations < 1 and self.initial_weights_fn is None:
            raise ValueError(
                "num_proposal_network_iterations must be >= 1 unless a net-free "
                "initial_weights_fn (occupancy grid) drives the sampling"
            )

    def __call__(
        self,
        ray_bundle: RayBundle,
        density_fns: List[Callable[[torch.Tensor], torch.Tensor]],
        generator: Optional[torch.Generator] = None,
        anneal: float = 1.0,
        update_proposals: bool = True,
        uniforms: Optional["SamplerUniforms"] = None,
    ) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
        """``update_proposals=False`` runs the proposal densities without a
        graph, so no gradient reaches the proposal nets (reference :304-312).
        ``uniforms`` replaces the draws from ``generator``."""
        assert len(density_fns) == self.num_proposal_network_iterations
        if uniforms is None:
            uniforms = SamplerUniforms(None, (None,) * (self.num_proposal_network_iterations + 1))
        initial = self.initial_sampler or UniformLinDispPiecewiseSampler(
            self.num_proposal_samples_per_ray[0], single_jitter=self.single_jitter
        )
        pdf = PDFSampler(num_samples=self.num_nerf_samples_per_ray, single_jitter=self.single_jitter)

        weights_list: List[torch.Tensor] = []
        ray_samples_list: List[RaySamples] = []
        weights = None
        ray_samples: Optional[RaySamples] = None
        if self.initial_weights_fn is not None:
            # round 0 from a net-free weight source (occupancy grid probes)
            ray_samples = initial(
                ray_bundle, generator=generator, num_samples=self.num_initial_probes, uniforms=uniforms.probes
            )
            weights = self.initial_weights_fn(ray_samples).detach()
        for i in range(self.num_proposal_network_iterations + 1):
            is_prop = i < self.num_proposal_network_iterations
            num_samples = self.num_proposal_samples_per_ray[i] if is_prop else self.num_nerf_samples_per_ray
            if i == 0 and weights is None:
                ray_samples = initial(
                    ray_bundle, generator=generator, num_samples=num_samples, uniforms=uniforms.rounds[i]
                )
            else:
                annealed = torch.pow(weights, anneal)  # (reference :301-305)
                ray_samples = pdf(
                    ray_bundle, ray_samples, annealed, generator=generator, num_samples=num_samples,
                    uniforms=uniforms.rounds[i],
                )
            if is_prop:
                with torch.set_grad_enabled(update_proposals and torch.is_grad_enabled()):
                    density = density_fns[i](ray_samples.frustums.get_positions())
                weights = ray_samples.get_weights(density)
                weights_list.append(weights)
                ray_samples_list.append(ray_samples)
        assert ray_samples is not None
        return ray_samples, weights_list, ray_samples_list


# ---------------------------------------------------------------------------
# NeuS sampler (SDF-guided upsampling)


@dataclasses.dataclass(frozen=True)
class NeuSSampler:
    """Iterative SDF-guided upsampling (reference :331-395): a uniform round
    of ``num_samples``, then ``num_upsample_steps`` rounds that each take
    NeuS alphas at a fixed inverse spread ``base_variance * 2^i`` from the
    SDF at the current samples and add ``num_samples_importance //
    num_upsample_steps`` PDF samples to them (``include_original``,
    histogram padding 1e-5). The defaults end a ray with 64 + 4 * 17 = 132
    samples."""

    num_samples: int = 64
    num_samples_importance: int = 64
    num_upsample_steps: int = 4
    base_variance: float = 64.0
    single_jitter: bool = True

    def __call__(
        self,
        ray_bundle: RayBundle,
        sdf_fn: Callable[[RaySamples], torch.Tensor],
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[SamplerUniforms] = None,
    ) -> RaySamples:
        """``uniforms.rounds``: the uniform round's jitter, then one per
        upsampling round (each (num_rays, 1) with ``single_jitter``), in
        place of draws from ``generator``; with neither the samples are the
        eval path's midpoints. The bins of every round are stopped from the
        gradient, so the SDF passes run without a graph: the same values,
        and no activations kept for the backward."""
        rounds = (None,) * (self.num_upsample_steps + 1) if uniforms is None else uniforms.rounds
        if len(rounds) != self.num_upsample_steps + 1:
            raise ValueError(f"NeuSSampler takes {self.num_upsample_steps + 1} jitters, got {len(rounds)}")
        uniform = UniformSampler(self.num_samples, single_jitter=self.single_jitter)
        ray_samples = uniform(ray_bundle, generator=generator, uniforms=rounds[0])
        pdf = PDFSampler(
            num_samples=self.num_samples_importance // self.num_upsample_steps,
            include_original=True,
            single_jitter=self.single_jitter,
            histogram_padding=1e-5,
        )
        for i in range(self.num_upsample_steps):
            with torch.no_grad():
                sdf = sdf_fn(ray_samples)  # (..., S, 1)
            alphas = self._alphas_from_sdf(ray_samples, sdf, self.base_variance * 2**i)
            weights, _ = RaySamples.get_weights_and_transmittance_from_alphas(alphas)
            ray_samples = pdf(ray_bundle, ray_samples, weights, generator=generator, uniforms=rounds[i + 1])
        return ray_samples

    @staticmethod
    def _alphas_from_sdf(ray_samples: RaySamples, sdf: torch.Tensor, inv_s: float) -> torch.Tensor:
        """NeuS alphas at a fixed inverse spread (reference :374-395): the
        SDF at section midpoints, its slope clamped to [-1e3, 0] (the
        reference's clamp, not the upstream running minimum), sigmoid CDFs at
        the section ends; the last sample's alpha is 0."""
        deltas = ray_samples.deltas[..., 0]
        s = sdf[..., 0]
        prev_s, next_s = s[..., :-1], s[..., 1:]
        mid_s = (prev_s + next_s) * 0.5
        cos_val = (next_s - prev_s) / torch.clamp_min(deltas[..., :-1], 1e-10)
        cos_val = torch.clamp(torch.clamp_max(cos_val, 0.0), -1e3, 0.0)
        d = deltas[..., :-1]
        prev_cdf = torch.sigmoid((mid_s - cos_val * d * 0.5) * inv_s)
        next_cdf = torch.sigmoid((mid_s + cos_val * d * 0.5) * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
        return torch.cat([alpha, torch.zeros_like(alpha[..., :1])], dim=-1)[..., None]
