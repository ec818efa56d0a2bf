"""Nerfacto, eval forward (counterpart of ``nerfstudio_tpu/models/nerfacto.py``).

NearFarCollider -> occupancy-grid probes -> PDF -> block-layout proposal
density field (K1) -> PDF -> NerfactoField (K3 exact trilerp) -> rgb,
median and expected depth, accumulation. The config keeps the reference's
field names and defaults. Not ported: the training forward, losses,
callbacks and the occupancy-grid update, and the sampling options the
shipped config does not use (checked in ``NerfactoModel.__init__``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional, Tuple

import torch

from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.field_components.embedding import Embedding
from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.field_components.spatial_distortions import SceneContraction
from nerfstudio_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.ray_samplers import ProposalNetworkSampler
from nerfstudio_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.ops.occupancy import OccupancyGridState, init_occupancy_grid, probe_occupancy


@dataclasses.dataclass
class NerfactoModelConfig(ModelConfig):
    """(reference nerfacto.py:45-177): the same fields and defaults."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 8
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 4
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 64)
    num_nerf_samples_per_ray: int = 32
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    num_proposal_iterations: int = 2
    proposal_net_args_list: Tuple[Dict, ...] = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
    )
    proposal_initial_sampler: Literal["piecewise", "uniform"] = "piecewise"
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    orientation_loss_mult: float = 0.0001
    pred_normal_loss_mult: float = 0.001
    use_proposal_weight_anneal: bool = True
    use_average_appearance_embedding: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    predict_normals: bool = False
    disable_scene_contraction: bool = False
    use_occupancy_sampler: bool = True
    occ_proposal_levels: int = 0
    occ_weight_mode: Literal["binary", "density"] = "binary"
    occ_grid_resolution: int = 128
    occ_num_probes: int = 128
    occ_update_every: int = 16
    occ_cells_per_update: int = 262144
    occ_warmup_steps: int = 256
    occ_ema_decay: float = 0.95
    occ_threshold: float = 1e-3
    use_appearance_embedding: bool = True
    appearance_embed_dim: int = 32
    hash_grad_corner_sample: bool = True
    prop_stochastic_corner: bool = True
    field_z_pair: bool = False
    field_block: bool = True
    prop_block: bool = True
    eval_exact_trilerp: bool = True
    field_bwd_level_period: int = 0
    field_bwd_level_warmup: int = 512
    proposal_freeze_after: int = 0
    average_init_density: float = 0.01
    camera_optimizer_mode: Literal["off", "SO3xR3", "SE3"] = "SO3xR3"
    camera_opt_zero_mean: bool = True
    implementation: str = "xla"

    def __post_init__(self):
        if self._target is None:
            self._target = NerfactoModel


class NerfactoModel(Model):
    """(reference nerfacto.py:180-401), eval forward of the shipped sampling
    stack: occupancy-grid probes, then one learned proposal round."""

    def __init__(self, config: NerfactoModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        cfg = config
        unported = {
            "use_occupancy_sampler=False": not cfg.use_occupancy_sampler,
            "num_proposal_iterations=0": cfg.num_proposal_iterations < 1,
            'proposal_initial_sampler="uniform"': cfg.proposal_initial_sampler != "piecewise",
            'occ_weight_mode="density"': cfg.occ_weight_mode != "binary",
            "disable_scene_contraction=True": cfg.disable_scene_contraction,
        }
        if any(unported.values()):
            raise NotImplementedError(
                "nerfacto options not ported: " + ", ".join(k for k, v in unported.items() if v)
            )
        self.field = NerfactoField(
            aabb=scene_aabb,
            num_images=num_train_data,
            hidden_dim=cfg.hidden_dim,
            num_levels=cfg.num_levels,
            base_res=cfg.base_res,
            max_res=cfg.max_res,
            log2_hashmap_size=cfg.log2_hashmap_size,
            features_per_level=cfg.features_per_level,
            hidden_dim_color=cfg.hidden_dim_color,
            use_average_appearance_embedding=cfg.use_average_appearance_embedding,
            use_appearance_embedding=cfg.use_appearance_embedding,
            appearance_embedding_dim=cfg.appearance_embed_dim if cfg.use_appearance_embedding else 0,
            use_pred_normals=cfg.predict_normals,
            average_init_density=cfg.average_init_density,
            hash_block=cfg.field_block,
            exact_eval=cfg.eval_exact_trilerp,
            device=device,
        )
        # the grid replaces the first proposal round; the remaining net is
        # the fine one, the last entry of the args list
        net_args = cfg.proposal_net_args_list[-1]
        if cfg.occ_proposal_levels:
            net_args = {**net_args, "num_levels": cfg.occ_proposal_levels}
        self.proposal_networks = torch.nn.ModuleList([
            HashMLPDensityField(
                use_spatial_distortion=True,
                average_init_density=cfg.average_init_density,
                block=cfg.prop_block,
                device=device,
                **net_args,
            )
        ])

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as the reference's init does, from ``generator``."""
        for m in self.modules():
            if isinstance(m, (HashEncoding, MLP, Embedding)):
                m.reset_parameters(generator)

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        model_aux: Optional[OccupancyGridState] = None,
        anneal: float = 1.0,
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays; ``model_aux`` is the occupancy grid over the
        contracted, normalised cube (``init_aux``)."""
        cfg = self.config
        if self.training:
            raise NotImplementedError("the training forward is not ported: call model.eval()")
        if model_aux is None:
            raise ValueError("nerfacto renders through its occupancy grid: pass model_aux")
        if ray_bundle.nears is None or ray_bundle.fars is None:
            ray_bundle = NearFarCollider(cfg.near_plane, cfg.far_plane)(ray_bundle, training=False)

        def initial_weights_fn(probe_samples):
            pos01 = (SceneContraction(order="inf")(probe_samples.frustums.get_positions()) + 2.0) / 4.0
            return torch.where(probe_occupancy(model_aux, pos01) > 0.5, 1.0, 1e-3)[..., None]

        sampler = ProposalNetworkSampler(
            num_proposal_samples_per_ray=tuple(cfg.num_proposal_samples_per_ray[-1:]),
            num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
            num_proposal_network_iterations=1,
            single_jitter=cfg.use_single_jitter,
            initial_weights_fn=initial_weights_fn,
            num_initial_probes=cfg.occ_num_probes,
        )
        density_fns = [net.density_fn for net in self.proposal_networks]
        ray_samples, weights_list, ray_samples_list = sampler(ray_bundle, density_fns, anneal=anneal)

        field_outputs = self.field(ray_samples, compute_normals=cfg.predict_normals)
        weights = ray_samples.get_weights(field_outputs[FieldHeadNames.DENSITY])
        return {
            "rgb": renderers.render_rgb(
                field_outputs[FieldHeadNames.RGB], weights, background_color=cfg.background_color
            ),
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth(weights, ray_samples, method="median"),
            "expected_depth": renderers.render_depth(weights, ray_samples, method="expected"),
            "prop_depth_0": renderers.render_depth(weights_list[0], ray_samples_list[0], method="median"),
        }

    @staticmethod
    def init_aux(model: "NerfactoModel", config: NerfactoModelConfig, device=None) -> OccupancyGridState:
        """A fully occupied grid over the contracted, normalised cube (reference :405-413)."""
        return init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), config.occ_grid_resolution, device)
