"""Splatfacto pipeline: the full-image train step and the refine schedule
(counterpart of ``nerfstudio_tpu/pipelines/splat_pipeline.py``).

A train step is render (K4, K5, K6 forward), L1 + SSIM, backward (K6, then
K4 backward), the per-array Adam, then the densification statistics from
the ``means2d`` gradient. The gaussians stay in padded tensors of
``max_gaussians`` slots: the reference's capacity buckets and their re-jits
have no counterpart. The multi-camera mesh step, checkpoints and the CLI
are not ported."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfstudio_torch.data.datamanagers import FullImageDatamanager
from nerfstudio_torch.engine.optimizers import SplatAdam
from nerfstudio_torch.models.splatfacto import InitDraws, SplatAux, SplatfactoModel, init_gaussian_params
from nerfstudio_torch.utils.metrics import psnr, ssim


@dataclasses.dataclass
class SplatTrainState:
    """(reference :29-34) The params are leaf tensors the optimizer steps in place."""

    params: Dict[str, torch.Tensor]
    optimizer: SplatAdam
    aux: SplatAux
    step: int


class SplatPipeline:
    def __init__(self, datamanager: FullImageDatamanager, model: SplatfactoModel, max_steps: int = 30000):
        self.datamanager = datamanager
        self.model = model
        self.max_steps = max_steps

    def init_state(self, seed_points=None, scene_scale: float = 1.0, generator: Optional[torch.Generator] = None,
                   draws: Optional[InitDraws] = None, device=None) -> SplatTrainState:
        """(reference :88-106) Fresh gaussians at ``max_gaussians`` slots and
        a fresh optimizer."""
        params, aux = init_gaussian_params(self.model.config, seed_points, scene_scale, generator=generator,
                                           draws=draws, device=device)
        return self.state_from(params, aux)

    def state_from(self, params: Dict[str, torch.Tensor], aux: SplatAux, moments=None, step: int = 0) -> SplatTrainState:
        """A train state from arrays (e.g. ``utils.convert.splat_state_from_jax``)."""
        params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        optimizer = SplatAdam(params, self.max_steps)
        if moments is not None:
            optimizer.load_moments(moments)
        return SplatTrainState(params, optimizer, aux, int(step))

    # ------------------------------------------------------------------
    def train_step(
        self,
        state: SplatTrainState,
        c2w: torch.Tensor,
        K: Tuple[float, float, float, float],
        gt_image: torch.Tensor,
        background: Optional[torch.Tensor],
        width: int,
        height: int,
        sh_degree: int,
    ) -> Dict[str, torch.Tensor]:
        """One step (reference :162-254), in place on ``state``. c2w (3, 4) on
        the CPU; ``background`` (3,) is the random background draw (None for
        the configured colour). Returns the step's metrics as tensors."""
        params = state.params
        aux = state.aux
        probe = torch.zeros((params["means"].shape[0], 2), device=params["means"].device, requires_grad=True)
        outputs = self.model.render(params, aux.alive, c2w, K, width, height, sh_degree, background=background,
                                    means2d_probe=probe)
        loss, loss_dict = self.model.get_loss(outputs, gt_image)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            # screen-gradient norm in pixel units (reference :231-243)
            g_norm = torch.linalg.vector_norm(probe.grad, dim=-1) * (0.5 * max(width, height))
            visible = outputs["visible"]
            metrics = {
                "loss": loss.detach(),
                "l1": loss_dict["l1"].detach(),
                "ssim_loss": loss_dict["ssim_loss"].detach(),
                "psnr": psnr(outputs["rgb"], loss_dict["gt"]),
                "num_alive": aux.alive.sum(),
            }
            state.aux = SplatAux(
                alive=aux.alive,
                grad_accum=aux.grad_accum + torch.where(visible, g_norm, torch.zeros_like(g_norm)),
                grad_count=aux.grad_count + visible.to(torch.float32),
                max_radii=torch.maximum(aux.max_radii, outputs["radii"] / float(max(width, height))),
            )
        state.step += 1
        return metrics

    def refine(self, state: SplatTrainState, normals: Tuple[torch.Tensor, torch.Tensor], do_split: bool,
               do_cull_scale: bool, reset_alpha: bool, use_screen_size: bool = False) -> SplatTrainState:
        """(reference :391-423) In place on ``state``."""
        state.aux = self.model.refine(state.params, state.optimizer, state.aux, normals, do_split=do_split,
                                      do_cull_scale=do_cull_scale, reset_alpha=reset_alpha,
                                      use_screen_size=use_screen_size)
        return state

    def refine_draws(self, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two ``normal((m, 3))`` draws of one refine."""
        n_cap = self.model.config.max_gaussians
        m = min(self.model.config.max_refine_new, n_cap)
        dev = generator.device if generator is not None else None
        return tuple(torch.randn((m, 3), generator=generator, device=dev) for _ in range(2))

    # ------------------------------------------------------------------
    def camera(self, cameras, idx: int, downscale: int = 1):
        """(c2w (3, 4), K, width, height) of one camera at a downscale, with
        K in float32 as the reference's step receives it."""
        d = np.float32(downscale)
        K = tuple(float(np.float32(getattr(cameras, f)[idx, 0].item()) / d) for f in ("fx", "fy", "cx", "cy"))
        return (cameras.camera_to_worlds[idx], K, int(cameras.width[idx, 0]) // downscale,
                int(cameras.height[idx, 0]) // downscale)

    def train(self, state: SplatTrainState, num_iterations: int, generator: Optional[torch.Generator] = None):
        """Steps ``state.step`` to ``num_iterations - 1`` with the refine
        schedule (reference :511-651). Each step draws its background from
        ``generator`` when the config asks for a random one, and each refine
        its two normal draws. Returns (state, the last step's metrics)."""
        cfg = self.model.config
        dm = self.datamanager
        metrics = None
        for step in range(state.step, num_iterations):
            d = self.model.downscale_at(step)
            cam_idx, image = dm.next_train(step)
            c2w, K, w, h = self.camera(dm.train_cameras, cam_idx, d)
            if d > 1:
                # the reference's jax.image.resize "linear" (antialiased)
                image = F.interpolate(image.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                                      antialias=True, align_corners=False)[0].permute(1, 2, 0)
            background = None
            if cfg.background_color == "random":
                dev = generator.device if generator is not None else image.device
                background = torch.rand((3,), generator=generator, device=dev).to(image.device)
            metrics = self.train_step(state, c2w, K, image, background, w, h, self.model.sh_degree_at(step))
            if step > cfg.warmup_length and step % cfg.refine_every == 0:
                reset_period = cfg.reset_alpha_every * cfg.refine_every
                self.refine(
                    state, self.refine_draws(generator),
                    do_split=step < cfg.stop_split_at,
                    do_cull_scale=step > reset_period,
                    reset_alpha=step % reset_period == 0 and step < cfg.stop_split_at,
                    use_screen_size=reset_period < step < cfg.stop_screen_size_at,
                )
        return state, metrics

    # ------------------------------------------------------------------
    def _eval_background(self) -> Optional[torch.Tensor]:
        """A fixed eval background: black for a random training background
        (reference :670-685; the port has no dataparser alpha colour), else
        the configured colour."""
        if self.model.config.background_color != "random":
            return None
        return torch.zeros((3,), device=self.datamanager.train_images.device)

    @torch.no_grad()
    def render_eval_image(self, state: SplatTrainState, camera_idx: int) -> Dict[str, torch.Tensor]:
        """(reference :654-668) At the full SH degree."""
        c2w, K, w, h = self.camera(self.datamanager.eval_cameras, camera_idx)
        return self.model.render(state.params, state.aux.alive, c2w, K, w, h,
                                 sh_degree_active=self.model.config.sh_degree, background=self._eval_background())

    def get_eval_image_metrics(self, state: SplatTrainState, camera_idx: int):
        """PSNR and SSIM of one eval view (reference :687-726; LPIPS is not
        ported): (metrics, outputs)."""
        out = self.render_eval_image(state, camera_idx)
        gt = self.datamanager.eval_image(camera_idx)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + out["background"] * (1 - gt[..., 3:])
        return {"psnr": float(psnr(out["rgb"], gt)), "ssim": float(ssim(out["rgb"], gt))}, out
