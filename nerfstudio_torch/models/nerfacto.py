"""Nerfacto (counterpart of ``nerfstudio_tpu/models/nerfacto.py``).

SO3xR3 camera-opt (training) -> NearFarCollider -> occupancy-grid probes
-> PDF -> block-layout proposal density field (K1) -> PDF -> NerfactoField
(K1 in training, K3 exact trilerp at eval) -> rgb, median and expected
depth, accumulation (and the semantic logits of a config with
``use_semantics``, semantic-nerfw's); in training also the rgb,
interlevel, distortion and camera-opt losses, the per-step schedule
(``step_kwargs``) and the occupancy-grid update hook
(``make_aux_update_fn``). The config keeps the reference's field names and
defaults, and its sampling options: without the occupancy sampler every
proposal net of ``proposal_net_args_list`` runs (upstream nerfacto's
two-net stack, no grid); with it, ``num_proposal_iterations=0`` samples
from the grid's PDF alone, ``occ_weight_mode="density"`` weighs the probes
by the grid's EMA densities, ``proposal_initial_sampler="uniform"`` spaces
the probes uniformly, and ``disable_scene_contraction`` keeps the scene
box. With ``predict_normals`` the field also gives its density-gradient
normals and predicted normals: both rendered (``normals``,
``pred_normals``), and in training the orientation loss and the
predicted-normal loss (the normals' gradient stopped there). Not ported:
the non-block proposal net (``prop_block=False``, whose one-corner
stochastic path is retired) and the flat-layout field (``field_block=False``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Literal, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.cameras.camera_optimizers import CameraOptimizer, camera_opt_regularizer
from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.data.scene_box import SceneBox
from nerfstudio_torch.field_components.embedding import Embedding
from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames, SemanticFieldHead
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.field_components.spatial_distortions import SceneContraction
from nerfstudio_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_torch.model_components import renderers
from nerfstudio_torch.model_components.losses import (
    distortion_loss,
    interlevel_loss,
    mse_loss,
    orientation_loss,
    pred_normal_loss,
)
from nerfstudio_torch.model_components.ray_samplers import ProposalNetworkSampler, SamplerUniforms, UniformSampler
from nerfstudio_torch.model_components.scene_colliders import NearFarCollider
from nerfstudio_torch.models.base_model import Model, ModelConfig
from nerfstudio_torch.ops.occupancy import (
    OccupancyGridState,
    init_occupancy_grid,
    probe_density,
    probe_occupancy,
    update_occupancy_grid,
)
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.metrics import psnr


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
    """(reference nerfacto.py:180-571). The shipped sampling stack:
    occupancy-grid probes, then one learned proposal round. The mode
    (``.train()``/``.eval()``) plays the reference's ``train`` flag."""

    def __init__(self, config: NerfactoModelConfig, scene_aabb=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                 num_train_data: int = 1, device=None):
        super().__init__(config, scene_aabb, num_train_data)
        cfg = config
        if not cfg.prop_block:
            # the reference's non-block proposal net takes the one-corner
            # stochastic path (prop_stochastic_corner), which is retired
            raise NotImplementedError("nerfacto options not ported: prop_block=False")
        if not cfg.field_block:
            # the flat field runs only where a step of it is held against the
            # reference (generfacto's)
            raise NotImplementedError("nerfacto options not ported: field_block=False")
        device = resolve_device(device)
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
            # semantic-nerfw's config fields (reference nerfacto.py:201-203)
            use_semantics=getattr(cfg, "use_semantics", False),
            num_semantic_classes=getattr(cfg, "num_semantic_classes", 16),
            disable_scene_contraction=cfg.disable_scene_contraction,
            average_init_density=cfg.average_init_density,
            hash_block=cfg.field_block,
            exact_eval=cfg.eval_exact_trilerp,
            device=device,
        )
        # with the occupancy sampler the grid replaces the first proposal
        # round: the nets left are the last entries of the args list (the
        # fine one); without it every round has its net (reference :213-233)
        n_prop = self.num_proposal_rounds()
        args_list = cfg.proposal_net_args_list
        if cfg.use_occupancy_sampler:
            args_list = args_list[len(args_list) - n_prop:]
            if cfg.occ_proposal_levels:
                args_list = tuple({**a, "num_levels": cfg.occ_proposal_levels} for a in args_list)
        self.proposal_networks = torch.nn.ModuleList([
            HashMLPDensityField(
                aabb=scene_aabb,
                use_spatial_distortion=not cfg.disable_scene_contraction,
                average_init_density=cfg.average_init_density,
                block=cfg.prop_block,
                device=device,
                **args_list[min(i, len(args_list) - 1)],
            )
            for i in range(n_prop)
        ])
        self.camera_optimizer = CameraOptimizer(
            num_cameras=num_train_data, mode=cfg.camera_optimizer_mode,
            zero_mean_gauge=cfg.camera_opt_zero_mean, device=device,
        )

    def num_proposal_rounds(self) -> int:
        """Learned proposal rounds (reference :235-242): with the occupancy
        sampler at most one (none at ``num_proposal_iterations=0``), else
        ``num_proposal_iterations``."""
        if self.config.use_occupancy_sampler:
            return min(1, self.config.num_proposal_iterations)
        return self.config.num_proposal_iterations

    def normalized_coords(self, positions: torch.Tensor) -> torch.Tensor:
        """World -> the field's input cube (reference :244-254): contracted
        and normalised, or normalised by the scene box without contraction."""
        if not self.config.disable_scene_contraction:
            return (SceneContraction(order="inf")(positions) + 2.0) / 4.0
        aabb = torch.tensor(self.scene_aabb, dtype=torch.float32, device=positions.device)
        return SceneBox.get_normalized_positions(positions, aabb)

    def initial_weights_fn(self, grid: OccupancyGridState) -> Callable:
        """The probes' weights from the grid (reference :283-309): 1 in an
        occupied cell and 1e-3 elsewhere, or with ``occ_weight_mode
        "density"`` the compositing weights of the cells' EMA densities,
        floored at 1e-3."""

        def binary(probe_samples):
            occ = probe_occupancy(grid, self.normalized_coords(probe_samples.frustums.get_positions()))
            return torch.where(occ > 0.5, 1.0, 1e-3)[..., None]

        def density(probe_samples):
            sigma = probe_density(grid, self.normalized_coords(probe_samples.frustums.get_positions()))
            return torch.clamp_min(probe_samples.get_weights(sigma[..., None]), 1e-3)

        return density if self.config.occ_weight_mode == "density" else binary

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as the reference's init does, from ``generator``."""
        for m in self.modules():
            if isinstance(m, (HashEncoding, MLP, Embedding, SemanticFieldHead)):
                m.reset_parameters(generator)

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        model_aux: Optional[OccupancyGridState] = None,
        anneal: float = 1.0,
        update_proposals: bool = True,
        field_bwd_levels: Optional[Tuple[int, ...]] = None,
        field_bwd_scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[SamplerUniforms] = None,
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays (reference :262-401); ``model_aux`` is the
        occupancy grid over the field's input cube (``init_aux``; None
        without the occupancy sampler). In training the camera-opt
        correction applies, the samplers jitter from ``generator`` (or take
        ``uniforms``), a random background is drawn from it,
        ``update_proposals`` gates the proposal gradient
        and ``field_bwd_levels``/``_scale`` the field's table gradient; the
        outputs then also carry the background and the per-round weights and
        samples the losses need."""
        cfg = self.config
        if cfg.use_occupancy_sampler and model_aux is None:
            raise ValueError("nerfacto renders through its occupancy grid: pass model_aux")
        if self.training:
            ray_bundle = self.camera_optimizer.apply_to_raybundle(ray_bundle)
        else:
            generator = uniforms = None
        if ray_bundle.nears is None or ray_bundle.fars is None:
            ray_bundle = NearFarCollider(cfg.near_plane, cfg.far_plane)(ray_bundle, training=self.training)

        n_prop = self.num_proposal_rounds()
        sampler = ProposalNetworkSampler(
            num_proposal_samples_per_ray=tuple(cfg.num_proposal_samples_per_ray[-n_prop:]),
            num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
            num_proposal_network_iterations=n_prop,
            single_jitter=cfg.use_single_jitter,
            initial_sampler=(UniformSampler(cfg.num_proposal_samples_per_ray[0], single_jitter=cfg.use_single_jitter)
                             if cfg.proposal_initial_sampler == "uniform" else None),
            initial_weights_fn=self.initial_weights_fn(model_aux) if cfg.use_occupancy_sampler else None,
            num_initial_probes=cfg.occ_num_probes,
        )
        density_fns = [net.density_fn for net in self.proposal_networks]
        ray_samples, weights_list, ray_samples_list = sampler(
            ray_bundle, density_fns, generator=generator, anneal=anneal, update_proposals=update_proposals,
            uniforms=uniforms,
        )

        field_outputs = self.field(
            ray_samples, compute_normals=cfg.predict_normals,
            bwd_levels=field_bwd_levels if self.training else None, bwd_scale=field_bwd_scale,
        )
        weights = ray_samples.get_weights(field_outputs[FieldHeadNames.DENSITY])
        rgb, bg = renderers.render_rgb(
            field_outputs[FieldHeadNames.RGB], weights, background_color=cfg.background_color,
            return_background=True, generator=generator,
        )
        outputs = {
            "rgb": rgb,
            "accumulation": renderers.render_accumulation(weights),
            "depth": renderers.render_depth(weights, ray_samples, method="median"),
            "expected_depth": renderers.render_depth(weights, ray_samples, method="expected"),
        }
        for i in range(n_prop):
            outputs[f"prop_depth_{i}"] = renderers.render_depth(weights_list[i], ray_samples_list[i], method="median")
        if FieldHeadNames.SEMANTICS in field_outputs:
            # the weights detached unless pass_semantic_gradients (reference :367-378)
            sem_w = weights if getattr(cfg, "pass_semantic_gradients", False) else weights.detach()
            outputs["semantics"] = renderers.render_semantics(field_outputs[FieldHeadNames.SEMANTICS], sem_w)
        if cfg.predict_normals:  # (reference :378-393)
            outputs["normals"] = renderers.render_normals(field_outputs[FieldHeadNames.NORMALS], weights)
            outputs["pred_normals"] = renderers.render_normals(field_outputs[FieldHeadNames.PRED_NORMALS], weights)
        if self.training:
            outputs["background"] = bg
            outputs["weights_list"] = weights_list + [weights]
            outputs["ray_samples_list"] = ray_samples_list + [ray_samples]
            if cfg.predict_normals:
                outputs["rendered_orientation_loss"] = orientation_loss(
                    weights, field_outputs[FieldHeadNames.NORMALS], ray_bundle.directions)
                outputs["rendered_pred_normal_loss"] = pred_normal_loss(
                    weights, field_outputs[FieldHeadNames.NORMALS].detach(),
                    field_outputs[FieldHeadNames.PRED_NORMALS])
        return outputs

    def get_metrics_dict(self, outputs, batch) -> Dict[str, torch.Tensor]:
        """(reference :448-464). The distortion metric keeps its graph: the
        distortion loss reuses it."""
        pred, gt = renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background")
        )
        metrics = {"psnr": psnr(pred.detach(), gt)}
        if "weights_list" in outputs:
            metrics["distortion"] = distortion_loss(outputs["weights_list"], outputs["ray_samples_list"])
        if self.camera_optimizer.mode != "off":
            with torch.no_grad():
                pose_adj = self.camera_optimizer.pose_adjustment
                metrics["camera_opt_translation"] = torch.linalg.norm(pose_adj[:, :3], dim=-1).mean()
                metrics["camera_opt_rotation"] = torch.linalg.norm(pose_adj[:, 3:], dim=-1).mean()
        return metrics

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """(reference :466-539)"""
        cfg = self.config
        pred, gt = renderers.blend_background_for_loss_computation(
            outputs["rgb"], batch["image"], background=outputs.get("background")
        )
        loss_dict = {"rgb_loss": mse_loss(pred, gt)}
        if "weights_list" in outputs:
            loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * interlevel_loss(
                outputs["weights_list"], outputs["ray_samples_list"]
            )
            if metrics_dict and "distortion" in metrics_dict:
                dist = metrics_dict["distortion"]
            else:
                dist = distortion_loss(outputs["weights_list"], outputs["ray_samples_list"])
            loss_dict["distortion_loss"] = cfg.distortion_loss_mult * dist
            if cfg.predict_normals:
                loss_dict["orientation_loss"] = cfg.orientation_loss_mult * torch.mean(
                    outputs["rendered_orientation_loss"])
                loss_dict["pred_normal_loss"] = cfg.pred_normal_loss_mult * torch.mean(
                    outputs["rendered_pred_normal_loss"])
            if self.camera_optimizer.mode != "off":
                loss_dict["camera_opt_regularizer"] = camera_opt_regularizer(
                    self.camera_optimizer.pose_adjustment, trans_l2_penalty=1e-2, rot_l2_penalty=1e-3
                )
        return loss_dict

    @staticmethod
    def step_kwargs(step: int, config: NerfactoModelConfig) -> Dict:
        """Per-step proposal-weight anneal, proposal-update gate and
        level-subsampled field backward (reference :543-571)."""
        kwargs = {}
        if config.use_proposal_weight_anneal:
            n = config.proposal_weights_anneal_max_num_iters
            t = np.clip(step / n, 0, 1)
            s = config.proposal_weights_anneal_slope
            kwargs["anneal"] = float((s * t) / ((s - 1) * t + 1))
        else:
            kwargs["anneal"] = 1.0
        # update every step during warm-up, ramping to every N after
        every = int(
            np.clip(
                np.interp(step, [0, config.proposal_warmup], [0, config.proposal_update_every]),
                1,
                config.proposal_update_every,
            )
        )
        kwargs["update_proposals"] = step < config.proposal_warmup or step % every == 0
        if config.proposal_freeze_after and step >= config.proposal_freeze_after:
            kwargs["update_proposals"] = False
        P = config.field_bwd_level_period
        if P and step >= config.field_bwd_level_warmup:
            kwargs["field_bwd_levels"] = tuple(l for l in range(config.num_levels) if l % P == step % P)
            kwargs["field_bwd_scale"] = float(P)
        return kwargs

    @staticmethod
    def init_aux(model: "NerfactoModel", config: NerfactoModelConfig, device=None) -> Optional[OccupancyGridState]:
        """A fully occupied grid over the field's input cube (reference
        :405-413); None without the occupancy sampler."""
        if not config.use_occupancy_sampler:
            return None
        return init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), config.occ_grid_resolution,
                                   resolve_device(device))

    @staticmethod
    def make_aux_update_fn(model: "NerfactoModel", config: NerfactoModelConfig) -> Optional[Callable]:
        """The occupancy hook (reference :416-446): from step
        ``occ_warmup_steps``, every ``occ_update_every`` steps, refresh
        ``occ_cells_per_update`` random cells of ``state.aux`` with the
        field's density (K1 forward, no graph). Call it before the step's
        train step. ``cells``/``jitter`` hand the draws in. None without the
        occupancy sampler."""
        if not config.use_occupancy_sampler:
            return None

        def hook(state, step: int, generator: Optional[torch.Generator] = None, cells=None, jitter=None):
            if state.aux is None or step < config.occ_warmup_steps or step % config.occ_update_every != 0:
                return state
            state.aux = update_occupancy_grid(
                state.aux, model.field.density_from_normalized, generator,
                occ_thre=config.occ_threshold, ema_decay=config.occ_ema_decay,
                cells_per_update=config.occ_cells_per_update, cells=cells, jitter=jitter,
            )
            return state

        return hook
