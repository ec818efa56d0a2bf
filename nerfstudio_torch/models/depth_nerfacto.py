"""Depth-supervised nerfacto (counterpart of
``nerfstudio_tpu/models/depth_nerfacto.py``).

nerfacto plus a depth loss on the last round's weights and samples where
the batch carries ``depth_image`` (a ``DepthDataset``'s maps: depth files,
or the SfM points projected into each camera; 0 marks a pixel without
depth): DS-NeRF's likelihood (the default) or URF's line-of-sight loss.
The Gaussian's sigma decays per step, ``max(0.2 * 0.99985^step, 0.01)``,
through ``step_kwargs`` as the trainer hands the schedule to every step."""

from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional

import torch

from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.model_components.losses import depth_loss
from nerfstudio_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig


@dataclasses.dataclass
class DepthNerfactoModelConfig(NerfactoModelConfig):
    """(reference depth_nerfacto.py:20-34): the same fields and defaults."""

    depth_loss_mult: float = 1e-3
    is_euclidean_depth: bool = False
    depth_sigma: float = 0.01
    should_decay_sigma: bool = True
    starting_depth_sigma: float = 0.2
    sigma_decay_rate: float = 0.99985
    depth_loss_type: Literal["ds_nerf", "urf"] = "ds_nerf"

    def __post_init__(self):
        if self._target is None:
            self._target = DepthNerfactoModel
        super().__post_init__()


class DepthNerfactoModel(NerfactoModel):
    """(reference depth_nerfacto.py:37-81)"""

    def get_outputs(self, ray_bundle: RayBundle, depth_sigma: Optional[float] = None,
                    **kwargs) -> Dict[str, torch.Tensor]:
        """nerfacto's outputs and the rays' ``directions_norm`` (the z-depth
        to distance factor the cameras put in the bundle's metadata); in
        training also the step's ``depth_sigma`` (the config's without
        one), which the loss reads."""
        outputs = super().get_outputs(ray_bundle, **kwargs)
        if ray_bundle.metadata is not None and "directions_norm" in ray_bundle.metadata:
            outputs["directions_norm"] = ray_bundle.metadata["directions_norm"]
        if self.training:
            sigma = self.config.depth_sigma if depth_sigma is None else depth_sigma
            outputs["depth_sigma"] = torch.tensor(sigma, dtype=torch.float32, device=outputs["rgb"].device)
        return outputs

    def get_loss_dict(self, outputs, batch, metrics_dict=None) -> Dict[str, torch.Tensor]:
        """nerfacto's losses and, where the batch has depths, ``depth_loss``
        (reference :49-66)."""
        loss_dict = super().get_loss_dict(outputs, batch, metrics_dict)
        if "depth_image" in batch and "weights_list" in outputs:
            cfg = self.config
            termination_depth = batch["depth_image"]
            loss_dict["depth_loss"] = cfg.depth_loss_mult * depth_loss(
                weights=outputs["weights_list"][-1],
                ray_samples=outputs["ray_samples_list"][-1],
                termination_depth=termination_depth,
                predicted_depth=outputs["expected_depth"],
                sigma=outputs["depth_sigma"],
                directions_norm=outputs.get("directions_norm", torch.ones_like(termination_depth)),
                is_euclidean=cfg.is_euclidean_depth,
                depth_loss_type=cfg.depth_loss_type,
            )
        return loss_dict

    @staticmethod
    def step_kwargs(step: int, config: DepthNerfactoModelConfig) -> Dict:
        """nerfacto's schedule and the decaying ``depth_sigma`` (reference :68-81)."""
        kwargs = NerfactoModel.step_kwargs(step, config)
        if config.should_decay_sigma:
            kwargs["depth_sigma"] = max(config.starting_depth_sigma * config.sigma_decay_rate**step,
                                        config.depth_sigma)
        else:
            kwargs["depth_sigma"] = config.depth_sigma
        return kwargs
