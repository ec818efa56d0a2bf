"""Generative (text-to-3D) pipeline for generfacto (counterpart of
``nerfstudio_tpu/pipelines/generative_pipeline.py``).

A step draws a random orbit camera, renders its full low-resolution image,
asks the guidance for the SDS gradient of that image, and backpropagates
the surrogate loss whose rgb gradient is that gradient, plus the opacity
term, then steps Adam (lr 1e-2, eps 1e-15, every parameter, as the
reference's optax Adam). The reference renders twice per step under ``jit``
(the image for the guidance, then the same render with the same key inside
the update) and XLA drops what no loss reads; here one render, which
computes only the loss's inputs, serves both: a render is a deterministic
function of the parameters and the draws. So a step launches K7's forward
once and its backward once, for the table gradient alone. Draws come from
one ``torch.Generator`` or are handed in (``GenerativeDraws``); the camera
draws are the datamanager's numpy generator, in the reference's order.
``train_generfacto`` is the CLI's run: a checkpoint in the port's format
(``engine.trainer.write_checkpoint``) at the end, as the reference saves
once."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from nerfstudio_torch.data.random_cameras_datamanager import RandomCamerasConfig, RandomCamerasDataManager
from nerfstudio_torch.engine.optimizers import AdamOptimizerConfig, PerGroupAdam
from nerfstudio_torch.engine.trainer import write_checkpoint
from nerfstudio_torch.generative.sds import load_guidance
from nerfstudio_torch.models.generfacto import GenerfactoDraws, GenerfactoModel, GenerfactoModelConfig
from nerfstudio_torch.utils.device import resolve_device

# optax.adam(1e-2, eps=1e-15) over every parameter: the model's one
# top-level module is its field
ADAM = {"field": {"optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15), "scheduler": None}}


@dataclasses.dataclass
class GenerativeTrainState:
    """The parameters live in the pipeline's model; the optimizer steps them in place."""

    optimizer: PerGroupAdam
    step: int = 0


@dataclasses.dataclass
class GenerativeDraws:
    """One step's draws: the render's, and the guidance's noise (the stub's
    standard normal of the image's shape; a backend's latent or pixel
    noise)."""

    model: GenerfactoDraws = dataclasses.field(default_factory=GenerfactoDraws)
    sds_noise: Optional[torch.Tensor] = None


class GenerativePipeline:
    def __init__(self, config, seed: int = 42, device=None):
        self.config = config
        self.model_cfg: GenerfactoModelConfig = config.model
        self.device = resolve_device(device)
        cam_cfg = getattr(config, "random_cameras", None) or RandomCamerasConfig()
        self.datamanager = RandomCamerasDataManager(cam_cfg, seed=seed, device=self.device)
        self.model = GenerfactoModel(self.model_cfg, scene_aabb=((-1.0,) * 3, (1.0,) * 3), num_train_data=1,
                                     device=self.device).train()
        self.guidance = load_guidance(self.model_cfg.guidance_backend, device=self.device)
        embedding = self.guidance.text_embedding(self.model_cfg.prompt)
        self.text_embedding = embedding.to(self.device) if isinstance(embedding, torch.Tensor) else embedding

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None) -> GenerativeTrainState:
        """Fresh parameters from ``generator`` and a fresh Adam. One camera
        is drawn and dropped, as the reference's init renders one to trace
        the model, so the steps' cameras are the reference's."""
        self.datamanager.next_train(0)
        self.model.reset_parameters(generator)
        return GenerativeTrainState(PerGroupAdam(ADAM, self.model), 0)

    def restore(self, state: GenerativeTrainState, payload: Dict[str, Any]) -> None:
        """The model, the Adam moments and count and the step from a
        checkpoint's payload (``checkpoint``, or ``utils.convert.
        trainer_checkpoint_from_jax`` of a reference state), in place."""
        self.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])

    def checkpoint(self, state: GenerativeTrainState) -> Dict[str, Any]:
        return {"step": state.step, "model": self.model.state_dict(), "optimizer": state.optimizer.state_dict()}

    # ------------------------------------------------------------------
    def train_step(self, state: GenerativeTrainState, step: int, generator: Optional[torch.Generator] = None,
                   draws: Optional[GenerativeDraws] = None) -> Dict[str, torch.Tensor]:
        """One step at ``step`` (the density blob's taper), its draws from
        ``generator`` where ``draws`` does not hand them in; the gradients
        stay on the parameters after Adam. Returns the loss and its terms."""
        if generator is None and draws is None:
            raise ValueError("a generative step draws from a generator or takes its draws")
        draws = draws or GenerativeDraws()
        cams, _, _ = self.datamanager.next_train(step)
        res = self.datamanager.config.train_resolution
        rays = cams.generate_rays(camera_indices=0).flatten()
        state.optimizer.zero_grad()
        outputs = self.model(rays, generator=generator, draws=draws.model, loss_only=True,
                             **GenerfactoModel.step_kwargs(step, self.model_cfg))
        sds_grad = self.guidance.sds_grad(outputs["rgb"].detach().reshape(res, res, 3), self.text_embedding,
                                          guidance_scale=self.model_cfg.guidance_scale, generator=generator,
                                          noise=draws.sds_noise)
        loss_dict = GenerfactoModel.get_loss_dict(outputs, {"sds_grad": sds_grad.reshape(-1, 3)}, self.model_cfg)
        loss = sum(loss_dict.values())
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in loss_dict.items()}}

    def train(self, state: GenerativeTrainState, num_iterations: int, generator: torch.Generator, writer=None,
              log_every: int = 50) -> GenerativeTrainState:
        for step in range(state.step, num_iterations):
            metrics = self.train_step(state, step, generator)
            if writer is not None and step % log_every == 0:
                writer.put_dict("train", {k: float(v) for k, v in metrics.items()}, step)
        return state

    # ------------------------------------------------------------------
    def render_eval_image(self, state: GenerativeTrainState, angle_idx: int = 0) -> Dict[str, torch.Tensor]:
        """Eval camera ``angle_idx`` rendered whole, in one call as the
        reference does (the expected depth's clip reads the whole batch):
        every output as (res, res, C), normals included (their position
        gradient taken locally)."""
        cams = self.datamanager.eval_cameras()[angle_idx]
        res = self.datamanager.config.eval_resolution
        rays = cams.generate_rays(camera_indices=0).flatten()
        self.model.eval()
        try:
            with torch.no_grad():
                out = self.model(rays)
        finally:
            self.model.train()
        return {k: v.reshape(res, res, -1) for k, v in out.items()}


def check_one_device(config) -> None:
    """Refuse a generfacto config that asks for more than one rank (the
    default, every card, means one for generfacto)."""
    machine = config.machine
    if (machine.num_devices or 1) > 1 or machine.num_machines > 1:
        raise ValueError("generfacto trains on one device: set --machine.num-devices 1 and --machine.num-machines 1")


def train_generfacto(config) -> Tuple[GenerativePipeline, GenerativeTrainState]:
    """The CLI's generfacto run on ``config.machine``'s device: parameters
    and draws from one generator seeded with ``config.seed``,
    ``trainer.max_num_iterations`` steps, the loss logged every 50 steps,
    one checkpoint at the end. One device: the reference trains it without
    the mesh."""
    from nerfstudio_torch.utils.writer import EventWriter

    check_one_device(config)
    device = config.machine.device()
    pipeline = GenerativePipeline(config, seed=config.seed, device=device)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    state = pipeline.init_state(generator)
    base = config.trainer.get_base_dir()
    pipeline.train(state, config.trainer.max_num_iterations, generator,
                   writer=EventWriter(base, vis=config.trainer.vis))
    ckpt_dir = config.trainer.get_checkpoint_dir(base)
    write_checkpoint(Path(ckpt_dir), state.step, pipeline.checkpoint(state))
    print(f"training finished; checkpoints in {ckpt_dir}", flush=True)
    return pipeline, state
