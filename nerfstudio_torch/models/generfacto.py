"""Generfacto: text-to-3D by score distillation (counterpart of
``nerfstudio_tpu/models/generfacto.py``).

A nerfacto field in the flat hash layout (K7, L16 F2 T=2^19, no scene
contraction, no appearance embedding) rendered from random orbit cameras
inside a unit sphere, with a Gaussian density blob at the origin that
tapers off over ``taper_range``; the guidance (``generative/sds.py``)
gives the image-space gradient, which the surrogate loss
``sum(rgb * sg(sds_grad))`` carries into the field, beside an opacity
term. ``get_outputs`` returns the reference's whole dict: rgb,
accumulation, expected depth, the density-gradient normals and, in
training with a light direction, the Lambertian ``shaded`` image. With
``loss_only`` it computes only what the loss reads (rgb and accumulation):
the reference's jitted update step computes the rest and drops it unread,
so the port's training step skips it (one K7 forward, one K7 backward of
the table gradient alone). The draws (the sampler's single jitter, the
random background, the light direction) come from a ``torch.Generator``
or are handed in (``GenerfactoDraws``); with neither the render is the
deterministic one over white."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.ray_samplers import UniformSampler
from nerfstudio_torch.model_components.scene_colliders import SphereCollider
from nerfstudio_torch.model_components.shaders import lambertian_shader
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.utils.device import resolve_device


@dataclasses.dataclass
class GenerfactoModelConfig(ModelConfig):
    """The reference's fields and defaults."""

    prompt: str = "a high quality photo of a pineapple"
    guidance_backend: str = "stable-diffusion"
    guidance_scale: float = 100.0
    num_samples_per_ray: int = 64
    opacity_loss_mult: float = 1.0
    orientation_loss_mult: float = 0.0001
    random_background: bool = True
    initialize_density_strength: float = 0.1
    taper_range: tuple = (0, 1000)
    sphere_collider_radius: float = 1.0

    def __post_init__(self):
        if self._target is None:
            self._target = GenerfactoModel


@dataclasses.dataclass
class GenerfactoDraws:
    """A training render's draws, each drawn from the generator where None:
    the sampler's jitter in [0, 1) (rays, 1), the random background in [0,
    1) (rays, 3), and the light direction, standard normal (3,), before
    normalisation."""

    jitter: Optional[torch.Tensor] = None
    background: Optional[torch.Tensor] = None
    light: Optional[torch.Tensor] = None


class GenerfactoModel(Model):
    """The mode (``.train()``/``.eval()``) plays the reference's ``train``
    flag."""

    def __init__(self, config: GenerfactoModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        self.field = NerfactoField(
            aabb=scene_aabb,
            num_images=1,
            use_appearance_embedding=False,
            appearance_embedding_dim=0,
            disable_scene_contraction=True,
            hash_block=False,
            device=resolve_device(device),
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as the reference's init does, from ``generator``."""
        for m in self.modules():
            if isinstance(m, (HashEncoding, MLP)):
                m.reset_parameters(generator)

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        density_strength: float = 0.1,
        generator: Optional[torch.Generator] = None,
        draws: Optional[GenerfactoDraws] = None,
        loss_only: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays. ``generator`` or ``draws`` play the
        reference's key: with either the sampler jitters, the background is
        random (``random_background``) and, in training, a light direction
        shades the render; with neither the samples sit on the bin edges
        over white."""
        cfg = self.config
        ray_bundle = SphereCollider(center=(0.0, 0.0, 0.0), radius=cfg.sphere_collider_radius)(
            ray_bundle, training=self.training)
        keyed = generator is not None or draws is not None
        draws = draws or GenerfactoDraws()
        device = ray_bundle.origins.device
        jitter = draws.jitter
        if keyed and jitter is None:
            jitter = torch.rand(ray_bundle.shape + (1,), generator=generator, device=device)
        rs = UniformSampler(cfg.num_samples_per_ray, single_jitter=True)(ray_bundle, uniforms=jitter)
        field_outputs = self.field(rs, compute_normals=not loss_only)
        # the density blob at the origin (reference :262-275)
        pos = rs.frustums.get_positions()
        blob = density_strength * torch.exp(-torch.sum(pos**2, dim=-1, keepdim=True) / (2 * 0.04))
        density = field_outputs[FieldHeadNames.DENSITY] + blob * 25.0
        weights = rs.get_weights(density)
        background = "random" if (cfg.random_background and keyed) else "white"
        rgb = renderers.render_rgb(field_outputs[FieldHeadNames.RGB], weights, background_color=background,
                                   generator=generator, background=draws.background)
        outputs = {"rgb": rgb, "accumulation": renderers.render_accumulation(weights)}
        if loss_only:
            return outputs
        normals = renderers.render_normals(field_outputs[FieldHeadNames.NORMALS], weights)
        outputs["depth"] = renderers.render_depth(weights, rs, method="expected")
        outputs["normals"] = normals
        if self.training and keyed:
            light = draws.light
            if light is None:
                light = torch.randn(3, generator=generator, device=device)
            light = light.to(device) / torch.linalg.norm(light.to(device))
            outputs["shaded"] = lambertian_shader(rgb, normals, light, shading_weight=0.7)
        return outputs

    @staticmethod
    def get_loss_dict(outputs, batch, config: Optional[GenerfactoModelConfig] = None) -> Dict[str, torch.Tensor]:
        """The SDS gradient enters as ``batch["sds_grad"]``, computed by the
        guidance on the rendered image: the surrogate ``sum(rgb *
        sg(sds_grad))``, whose gradient in rgb is that gradient, and the
        opacity term, its ``-log(clip(acc))`` weighed by 0 as the reference
        writes it."""
        loss_dict = {}
        if "sds_grad" in batch:
            loss_dict["sds_loss"] = torch.sum(outputs["rgb"] * batch["sds_grad"].detach())
        mult = config.opacity_loss_mult if config else 1.0
        acc = outputs["accumulation"]
        loss_dict["opacity_loss"] = mult * torch.mean(
            -torch.log(torch.clamp(acc, 1e-5, 1.0)) * 0.0 + torch.sqrt(acc**2 + 0.01)) * 0.1
        return loss_dict

    @staticmethod
    def step_kwargs(step: int, config: GenerfactoModelConfig) -> Dict[str, float]:
        """The density blob's strength, tapering linearly to 0 over ``taper_range``."""
        t0, t1 = config.taper_range
        frac = min(max((step - t0) / max(t1 - t0, 1), 0.0), 1.0)
        return {"density_strength": config.initialize_density_strength * (1.0 - frac)}
