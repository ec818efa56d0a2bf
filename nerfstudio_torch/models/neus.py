"""NeuS surface models (counterpart of ``nerfstudio_tpu/models/neus.py``).

``NeuSModel`` (plain neus) samples each ray by ``NeuSSampler``'s
SDF-guided upsampling inside the unit sphere (or between the near and far
planes) and holds what the NeuS family shares: the SDF field, NeuS alpha
compositing (``sample_and_render``), the metrics, the rgb and eikonal
losses and the cos-anneal schedule. ``NeuSFactoModel`` (neus-facto) samples
through two flat-layout proposal density fields (K7) after a uniform first
round inside the unit sphere, and adds the interlevel loss."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nerfstudio_torch.core.rays import RayBundle, RaySamples
from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_torch.fields.sdf_field import SDFField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.losses import interlevel_loss, mse_loss
from nerfstudio_torch.model_components.ray_samplers import (
    NeuSSampler,
    ProposalNetworkSampler,
    SamplerUniforms,
    UniformSampler,
)
from nerfstudio_torch.model_components.scene_colliders import NearFarCollider, SphereCollider
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.metrics import psnr


@dataclasses.dataclass
class NeuSModelConfig(ModelConfig):
    """(reference neus.py:32-55): the same fields and defaults."""

    num_samples: int = 64
    num_samples_importance: int = 64
    num_upsample_steps: int = 4
    near_plane: float = 0.05
    far_plane: float = 4.0
    background_color: str = "black"
    eikonal_loss_mult: float = 0.1
    cos_anneal_end: int = 20000
    use_sphere_collider: bool = True
    num_layers: int = 8
    hidden_dim: int = 256
    geo_feat_dim: int = 256
    num_layers_color: int = 4
    hidden_dim_color: int = 256
    sdf_bias: float = 0.8
    inside_outside: bool = False
    sdf_weight_norm: bool = True
    use_appearance_embedding: bool = False

    def __post_init__(self):
        if self._target is None:
            self._target = NeuSModel


class NeuSModel(Model):
    """(reference neus.py:61-172). The mode (``.train()``/``.eval()``)
    plays the reference's ``train`` flag."""

    def __init__(self, config: NeuSModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        cfg = config
        self.field = SDFField(
            num_layers=cfg.num_layers,
            hidden_dim=cfg.hidden_dim,
            geo_feat_dim=cfg.geo_feat_dim,
            num_layers_color=cfg.num_layers_color,
            hidden_dim_color=cfg.hidden_dim_color,
            bias=cfg.sdf_bias,
            inside_outside=cfg.inside_outside,
            weight_norm=cfg.sdf_weight_norm,
            num_images=num_train_data,
            use_appearance_embedding=cfg.use_appearance_embedding,
            device=resolve_device(device),
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as the reference's init does, from ``generator``."""
        self.field.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, (HashEncoding, MLP)):
                m.reset_parameters(generator)

    def sample_and_render(self, ray_samples: RaySamples, cos_anneal: float) -> Dict[str, torch.Tensor]:
        """Field, NeuS weights from the alphas, and the composited outputs
        (reference :81-107); in training also the SDF gradients, the
        weights and the background."""
        field_outputs = self.field(ray_samples, cos_anneal_ratio=cos_anneal)
        weights, _ = RaySamples.get_weights_and_transmittance_from_alphas(field_outputs[FieldHeadNames.ALPHA])
        rgb, background = renderers.render_rgb(
            field_outputs[FieldHeadNames.RGB], weights, background_color=self.config.background_color,
            return_background=True,
        )
        outputs = {
            "rgb": rgb,
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth(weights, ray_samples, method="expected"),
            "normals": renderers.render_normals(field_outputs[FieldHeadNames.NORMALS], weights),
        }
        if self.training:
            outputs["eikonal_gradients"] = field_outputs[FieldHeadNames.GRADIENT]
            outputs["weights"] = weights
            outputs["background"] = background
        return outputs

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        cosine_anneal: float = 1.0,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[SamplerUniforms] = None,
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (reference :109-140): the unit sphere's
        nears and fars (or the planes' without ``use_sphere_collider``), then
        ``NeuSSampler`` over the field's SDF. In training the sampler
        jitters from ``generator`` or takes ``uniforms`` (the rounds'
        jitters: the uniform round's, then one per upsampling round)."""
        cfg = self.config
        if ray_bundle.nears is None or ray_bundle.fars is None:
            collider = (SphereCollider((0.0, 0.0, 0.0), 1.0) if cfg.use_sphere_collider
                        else NearFarCollider(cfg.near_plane, cfg.far_plane))
            ray_bundle = collider(ray_bundle, training=self.training)
        sampler = NeuSSampler(num_samples=cfg.num_samples, num_samples_importance=cfg.num_samples_importance,
                              num_upsample_steps=cfg.num_upsample_steps)
        ray_samples = sampler(ray_bundle, self.field.get_sdf, generator=generator if self.training else None,
                              uniforms=uniforms if self.training else None)
        return self.sample_and_render(ray_samples, cosine_anneal)

    def get_metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """(reference :139-149) PSNR against the ground truth blended over
        the background the renderer used."""
        pred, gt = renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background")
        )
        return {"psnr": psnr(pred.detach(), gt)}

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """(reference :151-166) rgb MSE (an RGBA ground truth blended over the
        renderer's background, else the config's colour), and in training
        the eikonal term ``mult * mean((|grad sdf| - 1)^2)`` over every
        sample."""
        pred, gt = renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background"),
            background_color=self.config.background_color,
        )
        loss_dict = {"rgb_loss": mse_loss(pred, gt)}
        if "eikonal_gradients" in outputs:
            g = outputs["eikonal_gradients"]
            loss_dict["eikonal_loss"] = self.config.eikonal_loss_mult * torch.mean(
                (torch.linalg.norm(g, dim=-1) - 1.0) ** 2
            )
        return loss_dict

    @staticmethod
    def step_kwargs(step: int, config) -> Dict:
        """The cos-anneal ratio, step / cos_anneal_end up to 1 (reference :168-172)."""
        anneal_end = getattr(config, "cos_anneal_end", 20000)
        return {"cosine_anneal": min(1.0, step / max(anneal_end, 1))}


@dataclasses.dataclass
class NeuSFactoModelConfig(NeuSModelConfig):
    """(reference neus.py:175-187)"""

    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_neus_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    use_single_jitter: bool = True

    def __post_init__(self):
        if self._target is None:
            self._target = NeuSFactoModel


class NeuSFactoModel(NeuSModel):
    """NeuS with proposal sampling (reference neus.py:190-268): a sphere
    collider of radius 1, a uniform first round of 256 samples, two
    proposal density fields on the flat hash layout (K7, no contraction,
    scene-box normalisation), then 48 NeuS samples."""

    def __init__(self, config: NeuSFactoModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        device = resolve_device(device)
        super().__init__(config, scene_aabb, num_train_data, device)
        self.proposal_networks = nn.ModuleList(
            HashMLPDensityField(use_spatial_distortion=False, device=device)
            for _ in range(config.num_proposal_iterations)
        )

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        cosine_anneal: float = 1.0,
        anneal: float = 1.0,
        update_proposals: bool = True,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[SamplerUniforms] = None,
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (reference :223-250). In training the
        samplers jitter from ``generator`` (or take ``uniforms``: the rounds'
        jitters, the probes' unused) and the outputs also carry the
        per-round weights and samples of the interlevel loss."""
        cfg = self.config
        if ray_bundle.nears is None or ray_bundle.fars is None:
            ray_bundle = SphereCollider((0.0, 0.0, 0.0), 1.0)(ray_bundle, training=self.training)
        sampler = ProposalNetworkSampler(
            num_proposal_samples_per_ray=tuple(cfg.num_proposal_samples_per_ray),
            num_nerf_samples_per_ray=cfg.num_neus_samples_per_ray,
            num_proposal_network_iterations=cfg.num_proposal_iterations,
            single_jitter=cfg.use_single_jitter,
            initial_sampler=UniformSampler(cfg.num_proposal_samples_per_ray[0], single_jitter=cfg.use_single_jitter),
        )
        density_fns = [net.density_fn for net in self.proposal_networks]
        ray_samples, weights_list, ray_samples_list = sampler(
            ray_bundle, density_fns, generator=generator if self.training else None, anneal=anneal,
            update_proposals=update_proposals, uniforms=uniforms if self.training else None,
        )
        outputs = self.sample_and_render(ray_samples, cosine_anneal)
        if self.training:
            outputs["weights_list"] = weights_list + [outputs.pop("weights")]
            outputs["ray_samples_list"] = ray_samples_list + [ray_samples]
        return outputs

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """NeuS's losses plus the interlevel loss, unweighted (reference :252-262)."""
        loss_dict = super().get_loss_dict(outputs, batch, metrics_dict)
        if "weights_list" in outputs:
            loss_dict["interlevel_loss"] = interlevel_loss(outputs["weights_list"], outputs["ray_samples_list"])
        return loss_dict

    @staticmethod
    def step_kwargs(step: int, config) -> Dict:
        """(reference :264-268) the cos anneal; proposal weights unannealed and
        the proposals updated every step."""
        kw = NeuSModel.step_kwargs(step, config)
        kw["anneal"] = 1.0
        kw["update_proposals"] = True
        return kw
