"""The training step (counterpart of
``nerfstudio_tpu/pipelines/base_pipeline.py`` ``TrainState`` and
``build_train_step``).

One step samples pixels from the device-resident images, generates their
rays, runs the model's training forward, the metrics and the losses, then
the backward and the optimizer step. Nothing in it reads a device value on
the host: ``loss.item()`` and the like are the caller's. The eval side
renders eval images in chunks (``models.base_model.render_camera``) and
reports PSNR, SSIM and render speed; where the eval dataset's parser
blends RGBA onto an ``alpha_color`` the eval renders composite onto that
colour too (the reference's eval background override). The reference's
multi-step scan dispatch (``build_train_step_scan``), the per-loss
coefficients (every caller keeps the default 1), the viewer's preview
renderer and LPIPS are not ported."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.data.datamanagers import DeviceCacheDataManager
from nerfstudio_torch.model_components.renderers import background_color_override_context
from nerfstudio_torch.model_components.ray_generators import generate_rays_from_indices
from nerfstudio_torch.model_components.ray_samplers import SamplerUniforms
from nerfstudio_torch.models.base_model import Model, render_camera
from nerfstudio_torch.utils.metrics import psnr, ssim


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
    pixel indices (R, 3) (camera, row, col), the sampler's uniforms and, for
    a model that renders over a random background (instant-ngp), its
    colours (R, 3)."""

    pixels: torch.Tensor
    sampler: SamplerUniforms
    background: Optional[torch.Tensor] = None


class VanillaPipeline:
    """(reference :48-176)"""

    def __init__(self, datamanager: DeviceCacheDataManager, model: Model):
        self.datamanager = datamanager
        self.model = model
        # the model's hook on the train state before each step (nerfacto's
        # occupancy update): ``fn(state, step, generator)``
        self.aux_update_fn: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return self.datamanager.device

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
        if draws is not None and draws.background is not None:
            step_kwargs = {"background": draws.background, **step_kwargs}
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

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _eval_model(self):
        """The model in eval mode for a ``with`` block, then its mode back."""
        was_training = self.model.training
        try:
            yield self.model.eval()
        finally:
            self.model.train(was_training)

    def _eval_background(self) -> Optional[torch.Tensor]:
        """The eval renders' background (reference :248-261): the eval
        dataset's ``alpha_color``, onto which its parser blends RGBA ground
        truth at load, on the device; None where it has none."""
        color = getattr(getattr(self.datamanager.eval_dataset, "_dataparser_outputs", None), "alpha_color", None)
        return None if color is None else torch.as_tensor(color, dtype=torch.float32).to(self.device)

    @contextlib.contextmanager
    def _eval_context(self):
        """The model in eval mode, under the eval background's override
        where there is one (reference ``build_eval_chunk``, :263-279)."""
        color = self._eval_background()
        with self._eval_model() as model:
            if color is None:
                yield model
            else:
                with background_color_override_context(color):
                    yield model

    def eval_rays(self, state: TrainState, ray_bundle) -> Dict[str, torch.Tensor]:
        """The eval forward of a batch of rays (reference's eval chunk)."""
        kwargs = {} if state.aux is None else {"model_aux": state.aux}
        with self._eval_context() as model, torch.no_grad():
            return model(ray_bundle, **kwargs)

    def render_eval_camera(self, state: TrainState, camera_idx: int, chunk_size: Optional[int] = None):
        """One eval camera's image outputs (H, W, C), rendered in chunks of
        ``chunk_size`` rays (None: the model's ``eval_num_rays_per_chunk``)."""
        chunk = chunk_size or self.model.config.eval_num_rays_per_chunk
        with self._eval_context() as model:
            return render_camera(model, None, self.datamanager.eval_cameras, camera_idx, chunk, aux=state.aux)

    def get_eval_image_metrics_and_images(self, state: TrainState, camera_idx: int,
                                          chunk_size: Optional[int] = None) -> Tuple[Dict[str, float], Dict]:
        """PSNR, SSIM and the render's rays/s and fps of one eval image, and
        the images (reference base_pipeline.py:334-382). An RGBA ground truth
        is blended over the model's background colour (black for
        ``last_sample`` and ``random``)."""
        cam_idx, batch = self.datamanager.eval_image(camera_idx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        outputs = self.render_eval_camera(state, cam_idx, chunk_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        render_dt = time.perf_counter() - t0
        gt = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(self.device)
        pred = outputs["rgb"]
        if gt.shape[-1] == 4:
            bg = getattr(self.model.config, "background_color", "black")
            color = 1.0 if bg == "white" else 0.0
            gt = gt[..., :3] * gt[..., 3:] + color * (1.0 - gt[..., 3:])
        h, w = pred.shape[:2]
        metrics = {"psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt)),
                   "num_rays_per_sec": h * w / render_dt, "fps": 1.0 / render_dt}
        images = {"img": torch.cat([gt, pred], dim=1).cpu().numpy()}
        images.update({k: v for k, v in outputs.items() if k != "rgb"})
        return metrics, images

    def get_average_eval_image_metrics(self, state: TrainState, chunk_size: Optional[int] = None) -> Dict[str, float]:
        """Every eval image's metrics, mean and std (reference
        base_pipeline.py:384-414), after one untimed render per image size."""
        cams = self.datamanager.eval_cameras
        n = len(self.datamanager.eval_dataset)
        seen = set()
        for i in range(n):
            cam_idx, _ = self.datamanager.eval_image(i)
            hw = (int(cams.height[cam_idx, 0]), int(cams.width[cam_idx, 0]))
            if hw not in seen:
                seen.add(hw)
                self.render_eval_camera(state, cam_idx, chunk_size)
        return average_metrics([self.get_eval_image_metrics_and_images(state, i, chunk_size)[0] for i in range(n)])


def average_metrics(all_metrics) -> Dict[str, float]:
    """{k: mean, k_std: std} over a list of metric dicts."""
    out = {}
    for k in all_metrics[0]:
        vals = np.array([m[k] for m in all_metrics], dtype=np.float64)
        out[k] = float(vals.mean())
        out[f"{k}_std"] = float(vals.std())
    return out
