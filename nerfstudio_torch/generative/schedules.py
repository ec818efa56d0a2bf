"""Diffusion noise schedules and the SDS math (counterpart of
``nerfstudio_tpu/generative/schedules.py``), shared by the Stable Diffusion
(latent) and DeepFloyd (pixel) wrappers, in float32 as the reference
computes them.

``alphas_cumprod`` is a product of 1000 factors 1 - beta. The reference's
float32 ``cumprod`` may run as an associative scan: it lands up to 1.3e-6
relative from a float32 running product, and within 5e-7 of the product
taken here, 1 - beta and the product in float64, rounded once to float32."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from nerfstudio_torch.model_components.ray_samplers import linspace

Timestep = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Discrete DDPM schedule. ``scaled_linear`` is Stable Diffusion's
    (sqrt-space linear betas, beta_start 0.00085, beta_end 0.012);
    ``linear`` is DeepFloyd's and classic DDPM's."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    kind: str = "scaled_linear"  # scaled_linear | linear

    def betas(self, device=None) -> torch.Tensor:
        t = linspace(0.0, 1.0, self.num_train_timesteps, device)
        f32 = dict(dtype=torch.float32, device=t.device)
        start, end = torch.tensor(self.beta_start, **f32), torch.tensor(self.beta_end, **f32)
        if self.kind == "scaled_linear":
            return (torch.sqrt(start) + t * (torch.sqrt(end) - torch.sqrt(start))) ** 2
        return start + t * (end - start)

    def alphas_cumprod(self, device=None) -> torch.Tensor:
        return torch.cumprod(1.0 - self.betas(device).double(), dim=0).float()

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: Timestep) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_t) x0 + sqrt(1 - a_t) eps."""
        a = self.alphas_cumprod(x0.device)[t]
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def sds_weight(self, t: Timestep, device=None) -> torch.Tensor:
        """DreamFusion's w(t) = 1 - alpha_bar_t."""
        return 1.0 - self.alphas_cumprod(device)[t]


def sample_timestep(schedule: DDPMSchedule, generator: Optional[torch.Generator] = None,
                    t_min_frac: float = 0.02, t_max_frac: float = 0.98) -> int:
    """A uniform SDS timestep in the reference's [0.02, 0.98) band of the
    schedule, from ``generator`` (its device draws it)."""
    lo = int(schedule.num_train_timesteps * t_min_frac)
    hi = int(schedule.num_train_timesteps * t_max_frac)
    device = "cpu" if generator is None else generator.device
    return int(torch.randint(lo, hi, (), generator=generator, device=device))


def classifier_free_guidance(eps_uncond: torch.Tensor, eps_text: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """eps = eps_uncond + s (eps_text - eps_uncond)."""
    return eps_uncond + guidance_scale * (eps_text - eps_uncond)


def sds_gradient(schedule: DDPMSchedule, eps_pred: torch.Tensor, noise: torch.Tensor, t: Timestep) -> torch.Tensor:
    """d(SDS)/dx = w(t) (eps_pred - eps): the score-distillation gradient in
    whatever space eps lives in (latents for SD, pixels for IF)."""
    return schedule.sds_weight(t, eps_pred.device) * (eps_pred - noise)
