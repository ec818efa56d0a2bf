"""The training step (counterpart of
``nerfstudio_tpu/pipelines/base_pipeline.py`` ``TrainState`` and
``build_train_step``).

One step samples pixels from the device-resident images, generates their
rays, runs the model's training forward, the metrics and the losses, then
the backward and the optimizer step. Nothing in it reads a device value on
the host: ``loss.item()`` and the like are the caller's. The reference's
multi-step scan dispatch (``build_train_step_scan``), the per-loss
coefficients (every caller keeps the default 1) and the eval and render
programs (``render_camera`` is the model's) are not ported."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from nerfstudio_torch.data.datamanagers import DeviceCacheDataManager
from nerfstudio_torch.model_components.ray_generators import generate_rays_from_indices
from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
from nerfstudio_torch.models.base_model import Model


@dataclasses.dataclass
class TrainState:
    """What a step advances (reference :37-45): the optimizer (which holds
    the Adam moments and the schedule's count), the step, and the model's
    auxiliary state (nerfacto's occupancy grid; None for a model without
    one, such as neus-facto). The parameters are the model's."""

    optimizer: Any
    step: int = 0
    aux: Any = None


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """A step's random draws handed in, in place of the generator's: the
    pixel indices (R, 3) (camera, row, col) and the sampler's uniforms."""

    pixels: torch.Tensor
    sampler: SamplerUniforms


class VanillaPipeline:
    """(reference :48-176)"""

    def __init__(self, datamanager: DeviceCacheDataManager, model: Model):
        self.datamanager = datamanager
        self.model = model

    def train_step(
        self,
        state: TrainState,
        generator: Optional[torch.Generator] = None,
        draws: Optional[StepDraws] = None,
        **step_kwargs,
    ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a fresh ray batch; ``step_kwargs`` are the
        model's (``NerfactoModel.step_kwargs``, ``NeuSFactoModel.step_kwargs``).
        A state without aux passes the model no ``model_aux``. Returns the
        loss, the loss terms and the metrics, detached and on the device."""
        model = self.model
        if not model.training:
            raise ValueError("train_step trains the model: call model.train() first")
        idx, batch = self.datamanager.sample_train_batch(generator, indices=None if draws is None else draws.pixels)
        ray_bundle = generate_rays_from_indices(self.datamanager.train_cameras, idx)
        if state.aux is not None:
            step_kwargs = {"model_aux": state.aux, **step_kwargs}
        outputs = model(
            ray_bundle, generator=generator, uniforms=None if draws is None else draws.sampler, **step_kwargs,
        )
        metrics = model.get_metrics_dict(outputs, batch)
        loss_dict = model.get_loss_dict(outputs, batch, metrics)
        loss = sum(loss_dict.values())  # the reference's loss coefficients default to 1
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in {"loss": loss, **loss_dict, **metrics}.items()}
