"""TensoRF (counterpart of ``nerfstudio_tpu/models/tensorf.py``).

The rays meet the scene's aabb (``AABBBoxCollider``, nears at least 0.05 in
training); 200 uniform samples with one jitter per ray give the density
(no graph: no loss reads it), whose weights place 50 PDF samples; the field
colours those over white. Losses: the rgb MSE against the ground truth
blended over the renderer's background, and the total variation of the
density and colour planes (or the L1 of the density grids). The grids grow
at ``upsampling_iters`` to ``upsample_resolutions`` through
``make_upsample_hook``, which resamples them with K8's ``resize_linear``
and re-initialises the optimizer."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.fields.tensorf_field import TensoRFField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.losses import mse_loss, tv_loss
from nerfstudio_torch.model_components.ray_samplers import PDFSampler, SamplerUniforms, UniformSampler
from nerfstudio_torch.model_components.scene_colliders import AABBBoxCollider
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.metrics import psnr


@dataclasses.dataclass
class TensoRFModelConfig(ModelConfig):
    """(reference tensorf.py:27-46): the same fields and defaults."""

    init_resolution: int = 128
    final_resolution: int = 300
    upsampling_iters: Tuple[int, ...] = (2000, 3000, 4000, 5500, 7000)
    num_uniform_samples: int = 200
    num_samples: int = 50
    num_den_components: int = 16
    num_color_components: int = 48
    appearance_dim: int = 27
    regularization: str = "tv"  # none | l1 | tv
    l1_mult: float = 8e-5
    tv_mult: float = 1e-3
    background_color: str = "white"

    def __post_init__(self):
        if self._target is None:
            self._target = TensoRFModel


class TensoRFModel(Model):
    """(reference tensorf.py:49-199). The mode (``.train()``/``.eval()``)
    plays the reference's ``train`` flag."""

    def __init__(self, config: TensoRFModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        if config.regularization not in ("none", "l1", "tv"):
            raise ValueError(f"regularization {config.regularization!r}")
        self.field = TensoRFField(
            aabb=scene_aabb,
            density_resolution=config.init_resolution,
            color_resolution=config.init_resolution,
            density_components=config.num_den_components,
            color_components=config.num_color_components,
            appearance_dim=config.appearance_dim,
            device=resolve_device(device),
        )
        self.collider = AABBBoxCollider(tuple(map(tuple, scene_aabb)), near_plane=0.05)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.field.reset_parameters(generator)

    # -- progressive grid upsampling (reference :62-119) ----------------------

    @staticmethod
    def upsample_resolutions(config: TensoRFModelConfig) -> List[int]:
        """The grid resolution after each of ``upsampling_iters``: geometric
        from ``init_resolution`` to ``final_resolution``, rounded."""
        n = len(config.upsampling_iters)
        return np.round(np.exp(np.linspace(np.log(config.init_resolution), np.log(config.final_resolution),
                                           n + 1))).astype(int)[1:].tolist()

    @staticmethod
    def make_upsample_hook(model: "TensoRFModel", config: TensoRFModelConfig) -> Callable:
        """The hook before each step (reference :79-119): at a step of
        ``upsampling_iters``, both decompositions resampled to that step's
        resolution and the whole optimizer re-initialised (``state.optimizer
        .reset()``: every moment and count back to 0, so Adam's bias
        correction and the learning-rate schedule restart, as
        ``tx.init(new_params)`` does)."""
        milestones = dict(zip(config.upsampling_iters, TensoRFModel.upsample_resolutions(config)))

        def hook(state, step: int, generator: Optional[torch.Generator] = None):
            if step in milestones:
                model.field.upsample(int(milestones[step]))
                state.optimizer.reset()
            return state

        return hook

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """A state dict saved after an upsample: the grids first take its
        resolution, then its values."""
        for enc in (self.field.density_encoding, self.field.color_encoding):
            prefix = "field." + ("density" if enc is self.field.density_encoding else "color") + "_encoding."
            saved = state_dict.get(prefix + "plane_coef")
            if saved is not None and saved.shape != enc.plane_coef.shape:
                enc.plane_coef.data = enc.plane_coef.new_empty(saved.shape)
                enc.line_coef.data = enc.line_coef.new_empty(state_dict[prefix + "line_coef"].shape)
                enc.resolution = int(saved.shape[-1])
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    # -- forward and losses -----------------------------------------------------

    def get_outputs(self, ray_bundle: RayBundle, generator: Optional[torch.Generator] = None,
                    uniforms: Optional[SamplerUniforms] = None) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (reference :125-160). In training the
        samplers jitter from ``generator`` or take ``uniforms.rounds`` (the
        uniform sampler's (R, 1), the PDF sampler's (R, 51))."""
        cfg = self.config
        if ray_bundle.nears is None or ray_bundle.fars is None:
            ray_bundle = self.collider(ray_bundle, training=self.training)
        gen = generator if self.training else None
        u_coarse, u_fine = (None, None) if uniforms is None or not self.training else uniforms.rounds
        with torch.no_grad():
            coarse = UniformSampler(cfg.num_uniform_samples, single_jitter=True)(ray_bundle, gen, uniforms=u_coarse)
            weights_coarse = coarse.get_weights(self.field.get_density(coarse)[0])
        pdf = PDFSampler(cfg.num_samples, single_jitter=False, include_original=False)
        fine = pdf(ray_bundle, coarse, weights_coarse, gen, uniforms=u_fine)
        field_outputs = self.field(fine)
        weights = fine.get_weights(field_outputs[FieldHeadNames.DENSITY])
        rgb, background = renderers.render_rgb(field_outputs[FieldHeadNames.RGB], weights,
                                               background_color=cfg.background_color, return_background=True)
        outputs = {"rgb": rgb, "accumulation": renderers.render_accumulation(weights),
                   "depth": renderers.render_depth(weights, fine)}
        if self.training:
            outputs["background"] = background
        return outputs

    def _blended(self, outputs, batch):
        return renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background"), background_color="white")

    def get_metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """(reference :162-168)"""
        pred, gt = self._blended(outputs, batch)
        return {"psnr": psnr(pred.detach(), gt)}

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """(reference :170-195) the rgb MSE, and the regularizer on the
        grids: ``tv_mult`` times the TV of each decomposition's planes, or
        ``l1_mult`` times the mean |.| of the density planes and lines."""
        cfg = self.config
        pred, gt = self._blended(outputs, batch)
        loss_dict = {"rgb_loss": mse_loss(pred, gt)}
        denc, cenc = self.field.density_encoding, self.field.color_encoding
        if cfg.regularization == "l1":
            loss_dict["l1_reg"] = cfg.l1_mult * (torch.mean(torch.abs(denc.plane_coef))
                                                 + torch.mean(torch.abs(denc.line_coef)))
        elif cfg.regularization == "tv":
            loss_dict["tv_reg_density"] = cfg.tv_mult * tv_loss(denc.plane_coef)
            loss_dict["tv_reg_color"] = cfg.tv_mult * tv_loss(cenc.plane_coef)
        return loss_dict

    @staticmethod
    def step_kwargs(step: int, config) -> Dict:
        return {}
