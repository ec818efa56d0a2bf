"""Method registry (counterpart of ``nerfstudio_tpu/configs/method_configs.py``):
the ported methods' full configs (trainer, datamanager, dataparser, model,
per-group optimizers), with the reference's settings. The reference's other
methods raise ``NotImplementedError`` naming their ROADMAP item, and so do
the unported parsers phototourism and semantic-nerfw ship, until
``--dataparser`` names a ported one."""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

from nerfstudio_torch.configs.base_config import MachineConfig
from nerfstudio_torch.data.datamanagers import DataManagerConfig
from nerfstudio_torch.data.dataparsers.base_dataparser import DataParserConfig
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.data.dataparsers.registry import UnportedDataParserConfig
from nerfstudio_torch.engine.optimizers import (
    AdamOptimizerConfig,
    RAdamOptimizerConfig,
    nerfacto_optimizers,
    neus_facto_optimizers,
    neus_optimizers,
)
from nerfstudio_torch.engine.schedulers import ExponentialDecaySchedulerConfig
from nerfstudio_torch.engine.trainer import TrainerConfig
from nerfstudio_torch.models.base_model import ModelConfig
from nerfstudio_torch.models.depth_nerfacto import DepthNerfactoModelConfig
from nerfstudio_torch.models.instant_ngp import InstantNGPModelConfig
from nerfstudio_torch.models.mipnerf import MipNerfModelConfig
from nerfstudio_torch.models.nerfacto import NerfactoModelConfig
from nerfstudio_torch.models.neus import NeuSFactoModelConfig, NeuSModelConfig
from nerfstudio_torch.models.semantic_nerfw import SemanticNerfWModelConfig
from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig
from nerfstudio_torch.models.tensorf import TensoRFModelConfig
from nerfstudio_torch.models.vanilla_nerf import VanillaModelConfig


@dataclasses.dataclass
class MethodConfig:
    """A method's whole config (reference :30-52); ``machine`` says where it
    runs (``machine.device_type``)."""

    method_name: str = "base"
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    datamanager: DataManagerConfig = dataclasses.field(default_factory=DataManagerConfig)
    dataparser: DataParserConfig = dataclasses.field(default_factory=NerfstudioDataParserConfig)
    model: ModelConfig = dataclasses.field(default_factory=NerfactoModelConfig)
    optimizers: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    data: Optional[Path] = None
    seed: int = 42
    dataset: str = "input"
    machine: MachineConfig = dataclasses.field(default_factory=MachineConfig)

    def __post_init__(self):
        self.trainer.method_name = self.method_name


method_configs: Dict[str, MethodConfig] = {}
descriptions = {
    "nerfacto": "Recommended real->nerf model. Hash grid + proposal sampling.",
    "nerfacto-big": "Larger nerfacto (more features, longer schedule).",
    "nerfacto-huge": "Largest nerfacto.",
    "depth-nerfacto": "Nerfacto with depth supervision.",
    "semantic-nerfw": "Nerfacto with a semantic head.",
    "phototourism": "Nerfacto on unstructured photo collections.",
    "splatfacto": "3D Gaussian Splatting.",
    "splatfacto-big": "3DGS with more gaussians.",
    "splatfacto-mcmc": "3DGS with MCMC densification.",
    "neus": "NeuS SDF surface reconstruction.",
    "neus-facto": "NeuS with proposal sampling.",
    "vanilla-nerf": "Original NeRF (coarse/fine MLPs).",
    "mipnerf": "Mip-NeRF with integrated positional encoding.",
    "tensorf": "TensoRF vector-matrix decomposition.",
}

method_configs["nerfacto"] = MethodConfig(
    method_name="nerfacto",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500, steps_per_save=2000),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096),
    dataparser=NerfstudioDataParserConfig(),
    model=NerfactoModelConfig(eval_num_rays_per_chunk=1 << 15, field_bwd_level_period=2, proposal_freeze_after=2500),
    optimizers=nerfacto_optimizers(),
)

# the reference's two largest ray configs (reference :112-161), its
# speed knobs scaled to their 100k-step schedule
method_configs["nerfacto-big"] = MethodConfig(
    method_name="nerfacto-big",
    trainer=TrainerConfig(max_num_iterations=100000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=8192),
    dataparser=NerfstudioDataParserConfig(),
    model=NerfactoModelConfig(
        eval_num_rays_per_chunk=1 << 15,
        num_nerf_samples_per_ray=128,
        num_proposal_samples_per_ray=(512, 256),
        hidden_dim=128,
        hidden_dim_color=128,
        appearance_embed_dim=32,
        max_res=4096,
        proposal_weights_anneal_max_num_iters=5000,
        log2_hashmap_size=21,
        field_bwd_level_period=2,
        proposal_freeze_after=8000,
    ),
    optimizers=nerfacto_optimizers(max_steps=100000),
)

method_configs["nerfacto-huge"] = MethodConfig(
    method_name="nerfacto-huge",
    trainer=TrainerConfig(max_num_iterations=100000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=16384),
    dataparser=NerfstudioDataParserConfig(),
    model=NerfactoModelConfig(
        eval_num_rays_per_chunk=1 << 15,
        num_nerf_samples_per_ray=64,
        num_proposal_samples_per_ray=(512, 512),
        proposal_net_args_list=(
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 512},
            {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 7, "max_res": 2048},
        ),
        hidden_dim=256,
        hidden_dim_color=256,
        appearance_embed_dim=32,
        max_res=8192,
        proposal_weights_anneal_max_num_iters=5000,
        log2_hashmap_size=21,
        features_per_level=4,
        num_levels=16,
        field_bwd_level_period=2,
        proposal_freeze_after=8000,
    ),
    optimizers=nerfacto_optimizers(max_steps=100000),
)

# depth supervision (reference :261-274): the ply's points feed the SfM
# depth where the capture ships no depth files
method_configs["depth-nerfacto"] = MethodConfig(
    method_name="depth-nerfacto",
    dataset="depth",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    dataparser=NerfstudioDataParserConfig(load_3D_points=True),
    model=DepthNerfactoModelConfig(eval_num_rays_per_chunk=1 << 15, field_bwd_level_period=2,
                                   proposal_freeze_after=2500),
    optimizers=nerfacto_optimizers(),
)

# nerfacto with the semantic head (reference :371-379), without nerfacto's
# speed knobs; it ships the sitcoms3d parser
method_configs["semantic-nerfw"] = MethodConfig(
    method_name="semantic-nerfw",
    dataset="semantic",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    dataparser=UnportedDataParserConfig(name="sitcoms3d-data"),
    model=SemanticNerfWModelConfig(eval_num_rays_per_chunk=1 << 14),
    optimizers=nerfacto_optimizers(),
)

# nerfacto on photo collections (reference :384-392): the phototourism
# parser, the appearance embedding, no speed knobs
method_configs["phototourism"] = MethodConfig(
    method_name="phototourism",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    dataparser=UnportedDataParserConfig(name="phototourism-data"),
    model=NerfactoModelConfig(eval_num_rays_per_chunk=1 << 15, use_appearance_embedding=True),
    optimizers=nerfacto_optimizers(),
)

method_configs["splatfacto"] = MethodConfig(
    method_name="splatfacto",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500, steps_per_save=2000),
    datamanager=DataManagerConfig(),
    dataparser=NerfstudioDataParserConfig(load_3D_points=True),
    model=SplatfactoModelConfig(),
    optimizers={},  # the splat pipeline builds its own per-array Adam
)

method_configs["splatfacto-big"] = MethodConfig(
    method_name="splatfacto-big",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500, steps_per_save=2000),
    datamanager=DataManagerConfig(),
    dataparser=NerfstudioDataParserConfig(load_3D_points=True),
    model=SplatfactoModelConfig(cull_alpha_thresh=0.005, densify_grad_thresh=0.0006, max_gaussians=1000000),
    optimizers={},
)

# MCMC: relocation and growth toward max_gaussians, per-step position noise,
# the opacity and scale regularisers (reference :222-233)
method_configs["splatfacto-mcmc"] = MethodConfig(
    method_name="splatfacto-mcmc",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500, steps_per_save=2000),
    datamanager=DataManagerConfig(),
    dataparser=NerfstudioDataParserConfig(load_3D_points=True),
    model=SplatfactoModelConfig(strategy="mcmc", cull_alpha_thresh=0.005, max_gaussians=1000000),
    optimizers={},
)

method_configs["neus"] = MethodConfig(
    method_name="neus",
    trainer=TrainerConfig(max_num_iterations=100000, steps_per_eval_image=2500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=1024),
    dataparser=NerfstudioDataParserConfig(),
    model=NeuSModelConfig(eval_num_rays_per_chunk=1024),
    optimizers=neus_optimizers(),
)

method_configs["neus-facto"] = MethodConfig(
    method_name="neus-facto",
    trainer=TrainerConfig(max_num_iterations=20000, steps_per_eval_image=2500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=2048),
    dataparser=NerfstudioDataParserConfig(),
    model=NeuSFactoModelConfig(eval_num_rays_per_chunk=2048),
    optimizers=neus_facto_optimizers(),
)

# the Blender-protocol methods (reference :237-255, 277-291, 313-325): RAdam
# at a constant rate for the NeRFs (vanilla-nerf's temporal_distortion group
# has no parameters without D-NeRF's distortion), Adam decaying 1e-3 -> 1e-4
# over 30,000 steps for TensoRF
method_configs["vanilla-nerf"] = MethodConfig(
    method_name="vanilla-nerf",
    trainer=TrainerConfig(max_num_iterations=16500, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=1024),
    dataparser=BlenderDataParserConfig(),
    model=VanillaModelConfig(),
    optimizers={
        "field": {"optimizer": RAdamOptimizerConfig(lr=5e-4, eps=1e-8), "scheduler": None},
        "temporal_distortion": {"optimizer": RAdamOptimizerConfig(lr=5e-4, eps=1e-8), "scheduler": None},
    },
)

method_configs["mipnerf"] = MethodConfig(
    method_name="mipnerf",
    trainer=TrainerConfig(max_num_iterations=1000000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=1024),
    dataparser=BlenderDataParserConfig(),
    model=MipNerfModelConfig(num_coarse_samples=128, num_importance_samples=128, eval_num_rays_per_chunk=8192),
    optimizers={"field": {"optimizer": RAdamOptimizerConfig(lr=5e-4, eps=1e-8), "scheduler": None}},
)

method_configs["tensorf"] = MethodConfig(
    method_name="tensorf",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    dataparser=BlenderDataParserConfig(),
    model=TensoRFModelConfig(),
    optimizers={
        "field": {
            "optimizer": AdamOptimizerConfig(lr=0.001),
            "scheduler": ExponentialDecaySchedulerConfig(lr_final=0.0001, max_steps=30000),
        },
    },
)

def _instant_ngp_optimizers() -> Dict[str, Dict[str, Any]]:
    """Adam at 1e-2 (eps 1e-15) on the field, decaying exponentially to 1e-4
    over 30,000 steps (reference :167-172, :186-191)."""
    return {"field": {"optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15),
                      "scheduler": ExponentialDecaySchedulerConfig(lr_final=1e-4, max_steps=30000)}}


method_configs["instant-ngp"] = MethodConfig(
    method_name="instant-ngp",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    dataparser=NerfstudioDataParserConfig(),
    model=InstantNGPModelConfig(eval_num_rays_per_chunk=8192),
    optimizers=_instant_ngp_optimizers(),
)

method_configs["instant-ngp-bounded"] = MethodConfig(
    method_name="instant-ngp-bounded",
    trainer=TrainerConfig(max_num_iterations=30000, steps_per_eval_image=500),
    datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    dataparser=NerfstudioDataParserConfig(),
    model=InstantNGPModelConfig(eval_num_rays_per_chunk=8192, grid_resolution=128, disable_scene_contraction=True,
                                near_plane=0.01, background_color="black"),
    optimizers=_instant_ngp_optimizers(),
)

# the reference's other methods, by the ROADMAP queue 1 item that ports them
NOT_PORTED = {"dnerf": 15, "generfacto": 14}


def get_method(name: str) -> MethodConfig:
    """A fresh copy of the method's config."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"method {name!r} is not ported yet (ROADMAP queue 1 item {NOT_PORTED[name]})")
    if name not in method_configs:
        raise SystemExit(f"unknown method {name!r}; available: {', '.join(sorted(method_configs))}")
    return copy.deepcopy(method_configs[name])
