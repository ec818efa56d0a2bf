"""Instant-NGP (counterpart of ``nerfstudio_tpu/models/instant_ngp.py``).

The rays meet the scene (``AABBBoxCollider`` when bounded, near and far
planes at 0.05 and 1000 under scene contraction); ``OccupancyGridSampler``
probes 128 points a ray against the occupancy grid (uniform in the box, or
half uniform and half in disparity through the contracted, normalised
cube) and places 48 PDF samples by the occupied probes; the block-layout
hash-grid ``NerfactoField`` without appearance embedding (K1 in training,
K3 at eval) colours them over a random background in training, black at
eval (the eval background override wins over both). The grid lives in the
train state's aux from step 0 (``init_aux``) and is refreshed whole (every
cell, K1 forward without a graph) every 16 steps from step 256
(``make_aux_update_fn``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.field_components.embedding import Embedding
from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.field_components.spatial_distortions import SceneContraction
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.losses import mse_loss
from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms, UniformLinDispPiecewiseSampler
from nerfstudio_torch.model_components.scene_colliders import AABBBoxCollider, NearFarCollider
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.ops.occupancy import (
    OccupancyGridSampler,
    OccupancyGridState,
    init_occupancy_grid,
    update_occupancy_grid,
)
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.metrics import psnr


@dataclasses.dataclass
class InstantNGPModelConfig(ModelConfig):
    """(reference instant_ngp.py:38-84): the same fields and defaults.
    ``average_init_density`` None takes the variant's own: 1.0 bounded, 0.01
    under scene contraction. ``hash_grad_corner_sample`` is inert in the
    block layout (the reference's block path never reads it)."""

    grid_resolution: int = 128
    grid_update_every: int = 16
    grid_warmup_steps: int = 256
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_levels: int = 8
    features_per_level: int = 4
    num_coarse_probes: int = 128
    num_samples_per_ray: int = 48
    near_plane: float = 0.05
    far_plane: float = 1000.0
    use_appearance_embedding: bool = False
    background_color: str = "random"
    disable_scene_contraction: bool = False
    average_init_density: Optional[float] = None
    occ_threshold: float = 0.01
    occ_ema_decay: float = 0.95
    hash_grad_corner_sample: bool = True
    field_z_pair: bool = False
    field_block: bool = True

    def __post_init__(self):
        if self._target is None:
            self._target = InstantNGPModel


class InstantNGPModel(Model):
    """(reference instant_ngp.py:87-270). The mode (``.train()``/``.eval()``)
    plays the reference's ``train`` flag."""

    def __init__(self, config: InstantNGPModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        if config.field_z_pair:
            raise NotImplementedError("the z-pair hash layout is not ported: the port keeps the block layout")
        if not config.field_block:
            raise NotImplementedError("instant-ngp options not ported: field_block=False")
        self.field = NerfactoField(
            aabb=scene_aabb,
            num_images=num_train_data,
            max_res=config.max_res,
            log2_hashmap_size=config.log2_hashmap_size,
            num_levels=config.num_levels,
            features_per_level=config.features_per_level,
            use_appearance_embedding=config.use_appearance_embedding,
            appearance_embedding_dim=32 if config.use_appearance_embedding else 0,
            disable_scene_contraction=config.disable_scene_contraction,
            average_init_density=self.resolved_init_density(config),
            hash_block=config.field_block,
            device=resolve_device(device),
        )

    @staticmethod
    def resolved_init_density(cfg: InstantNGPModelConfig) -> float:
        """(reference :92-97)"""
        if cfg.average_init_density is not None:
            return cfg.average_init_density
        return 1.0 if cfg.disable_scene_contraction else 0.01

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as the reference's init does, from ``generator``."""
        for m in self.modules():
            if isinstance(m, (HashEncoding, MLP, Embedding)):
                m.reset_parameters(generator)

    def grid_aabb(self):
        """The occupancy grid's domain (reference :123-128): the scene's
        aabb when bounded, the contracted, normalised unit cube otherwise."""
        if self.config.disable_scene_contraction:
            return self.scene_aabb
        return ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))

    @staticmethod
    def normalized_coords(positions: torch.Tensor) -> torch.Tensor:
        """World -> the contracted, normalised cube (reference :130-134)."""
        return (SceneContraction(order="inf")(positions) + 2.0) / 4.0

    def sampler(self) -> OccupancyGridSampler:
        """(reference :156-181)"""
        cfg = self.config
        if cfg.disable_scene_contraction:
            return OccupancyGridSampler(num_coarse_probes=cfg.num_coarse_probes, num_samples=cfg.num_samples_per_ray)
        return OccupancyGridSampler(
            num_coarse_probes=cfg.num_coarse_probes,
            num_samples=cfg.num_samples_per_ray,
            coord_fn=self.normalized_coords,
            initial_sampler=UniformLinDispPiecewiseSampler(cfg.num_coarse_probes, train_stratified=False),
        )

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        model_aux: Optional[OccupancyGridState] = None,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[SamplerUniforms] = None,
        background: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (reference :136-207) through ``model_aux``,
        the occupancy grid. In training the PDF jitter comes from
        ``uniforms.rounds[0]`` ((R, 1)) or ``generator``, and the random
        background from ``background`` ((R, 3)) or ``generator``; the
        outputs then also carry that background, which the loss blends an
        RGBA ground truth over. At eval the samples are the PDF's midpoints
        and the random background is black."""
        cfg = self.config
        if model_aux is None:
            raise ValueError("instant-ngp renders through its occupancy grid: pass model_aux (init_aux)")
        if ray_bundle.nears is None or ray_bundle.fars is None:
            if cfg.disable_scene_contraction:
                collider = AABBBoxCollider(tuple(map(tuple, self.scene_aabb)), near_plane=cfg.near_plane)
            else:
                collider = NearFarCollider(cfg.near_plane, cfg.far_plane)
            ray_bundle = collider(ray_bundle, training=self.training)
        if not self.training:
            generator = uniforms = background = None
        jitter = None if uniforms is None else uniforms.rounds[0]
        ray_samples = self.sampler()(ray_bundle, model_aux, generator=generator, uniforms=jitter)

        field_outputs = self.field(ray_samples)
        weights = ray_samples.get_weights(field_outputs[FieldHeadNames.DENSITY])
        bg_color = cfg.background_color
        if not self.training and bg_color == "random":
            bg_color = "black"
        rgb, bg = renderers.render_rgb(field_outputs[FieldHeadNames.RGB], weights, background_color=bg_color,
                                       return_background=True, generator=generator, background=background)
        accumulation = renderers.render_accumulation(weights)
        outputs = {
            "rgb": rgb,
            "accumulation": accumulation,
            "depth": renderers.render_depth(weights, ray_samples, method="expected"),
            "num_samples_per_ray": torch.full_like(accumulation, cfg.num_samples_per_ray),
        }
        if self.training:
            outputs["background"] = bg
        return outputs

    def get_metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """(reference :209-215)"""
        pred, gt = renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background"))
        return {"psnr": psnr(pred.detach(), gt)}

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """(reference :217-223)"""
        pred, gt = renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background"))
        return {"rgb_loss": mse_loss(pred, gt)}

    @staticmethod
    def step_kwargs(step: int, config: InstantNGPModelConfig) -> Dict:
        return {}

    @staticmethod
    def init_aux(model: "InstantNGPModel", config: InstantNGPModelConfig, device=None) -> OccupancyGridState:
        """A fully occupied grid over ``grid_aabb`` (reference :227-231), in
        the train state from step 0 so checkpoints carry it."""
        return init_occupancy_grid(model.grid_aabb(), config.grid_resolution, resolve_device(device))

    @staticmethod
    def make_aux_update_fn(model: "InstantNGPModel", config: InstantNGPModelConfig) -> Callable:
        """The occupancy hook (reference :233-266): from step
        ``grid_warmup_steps``, every ``grid_update_every`` steps, refresh
        every cell of ``state.aux`` with the field's density at a jittered
        point of the cell (K1 forward, no graph): world positions through
        ``field.density_fn`` when bounded, the contracted cube's through
        ``field.density_from_normalized``. Call it before the step's train
        step; ``jitter`` ((res^3, 3)) hands the draw in."""
        density_fn = (model.field.density_fn if config.disable_scene_contraction
                      else model.field.density_from_normalized)

        def hook(state, step: int, generator: Optional[torch.Generator] = None, jitter=None):
            if step % config.grid_update_every != 0 or step < config.grid_warmup_steps:
                return state
            state.aux = update_occupancy_grid(state.aux, density_fn, generator, occ_thre=config.occ_threshold,
                                              ema_decay=config.occ_ema_decay, jitter=jitter)
            return state

        return hook
