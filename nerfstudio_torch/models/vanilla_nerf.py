"""NeRF with its coarse and fine passes (counterpart of
``nerfstudio_tpu/models/vanilla_nerf.py``): the near and far planes of
``collider_params``; 64 uniform samples through the coarse field, then 128
PDF samples merged with them through the fine field; each pass composited
over white. Losses: each pass's rgb MSE against the ground truth blended
over white. D-NeRF's temporal distortion (``enable_temporal_distortion``,
the ``dnerf`` method) is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from nerfstudio_torch.core.rays import RayBundle, RaySamples
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.losses import mse_loss
from nerfstudio_torch.model_components.ray_samplers import PDFSampler, SamplerUniforms, UniformSampler
from nerfstudio_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.metrics import psnr


@dataclasses.dataclass
class VanillaModelConfig(ModelConfig):
    """(reference vanilla_nerf.py:28-38): the same fields and defaults."""

    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    background_color: str = "white"
    enable_temporal_distortion: bool = False

    def __post_init__(self):
        if self._target is None:
            self._target = NeRFModel


class NeRFModel(Model):
    """(reference vanilla_nerf.py:41-143): two fields, coarse and fine. The
    mode (``.train()``/``.eval()``) plays the reference's ``train`` flag."""

    include_original = True

    def __init__(self, config: VanillaModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        if config.enable_temporal_distortion:
            raise NotImplementedError("D-NeRF's temporal distortion (the dnerf method) is not ported yet "
                                      "(ROADMAP queue 1 item 15)")
        self.make_fields(resolve_device(device))

    def make_fields(self, device) -> None:
        self.field_coarse = NeRFField(device=device)
        self.field_fine = NeRFField(device=device)

    def fields(self):
        """(coarse field, fine field)"""
        return self.field_coarse, self.field_fine

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for field in dict.fromkeys(self.fields()):
            field.reset_parameters(generator)

    def _render(self, field: NeRFField, ray_samples: RaySamples):
        """(weights, rgb over the background, accumulation, depth) of one pass."""
        out = field(ray_samples)
        weights = ray_samples.get_weights(out[FieldHeadNames.DENSITY])
        rgb = renderers.render_rgb(out[FieldHeadNames.RGB], weights, background_color=self.config.background_color)
        return (weights, rgb, renderers.render_accumulation(weights),
                renderers.render_depth(weights, ray_samples))

    def get_outputs(self, ray_bundle: RayBundle, generator: Optional[torch.Generator] = None,
                    uniforms: Optional[SamplerUniforms] = None) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (reference :51-112). In training the
        samplers jitter from ``generator`` or take ``uniforms.rounds``: the
        uniform sampler's (R, coarse + 1), the PDF sampler's (R, fine + 1)."""
        cfg = self.config
        if cfg.enable_collider and cfg.collider_params is not None:
            ray_bundle = NearFarCollider(cfg.collider_params["near_plane"], cfg.collider_params["far_plane"])(
                ray_bundle, training=self.training)
        gen = generator if self.training else None
        u_coarse, u_fine = (None, None) if uniforms is None or not self.training else uniforms.rounds
        field_coarse, field_fine = self.fields()
        rs_coarse = UniformSampler(cfg.num_coarse_samples)(ray_bundle, gen, uniforms=u_coarse)
        w_coarse, rgb_coarse, acc_coarse, depth_coarse = self._render(field_coarse, rs_coarse)
        pdf = PDFSampler(cfg.num_importance_samples, include_original=self.include_original)
        rs_fine = pdf(ray_bundle, rs_coarse, w_coarse, gen, uniforms=u_fine)
        _, rgb_fine, acc_fine, depth_fine = self._render(field_fine, rs_fine)
        return {"rgb_coarse": rgb_coarse, "rgb_fine": rgb_fine, "rgb": rgb_fine,
                "accumulation_coarse": acc_coarse, "accumulation_fine": acc_fine, "accumulation": acc_fine,
                "depth_coarse": depth_coarse, "depth_fine": depth_fine, "depth": depth_fine}

    def _blended(self, outputs, batch, level: str):
        return renderers.blend_background_for_loss_computation(outputs[f"rgb_{level}"], batch["image"],
                                                               background_color="white")

    def get_metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """(reference :114-127) the fine pass's PSNR and the coarse one's."""
        return {"psnr_coarse": psnr(*(x.detach() for x in self._blended(outputs, batch, "coarse"))),
                "psnr": psnr(*(x.detach() for x in self._blended(outputs, batch, "fine")))}

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """(reference :129-143)"""
        return {"rgb_loss_coarse": mse_loss(*self._blended(outputs, batch, "coarse")),
                "rgb_loss_fine": mse_loss(*self._blended(outputs, batch, "fine"))}

    @staticmethod
    def step_kwargs(step: int, config) -> Dict:
        return {}
