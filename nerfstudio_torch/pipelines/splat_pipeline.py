"""Splatfacto pipeline: the full-image train step and the refine schedule
(counterpart of ``nerfstudio_tpu/pipelines/splat_pipeline.py``).

A train step is render (K4, K5, K6 forward), L1 + SSIM, backward (K6, then
K4 backward), the per-array Adam, then the densification statistics from
the ``means2d`` gradient. As configured, the step first corrects the pose
by the camera's camera-opt tangent (the K4 backward then returns the
viewmat's gradient), slices the image's bilateral grid over the render,
adds the regularisers, and after Adam moves the means by MCMC's position
noise; ``train`` refines by the default strategy or by MCMC's relocation.
The gaussians stay in padded tensors of
``max_gaussians`` slots: the reference's capacity buckets and their re-jits
have no counterpart. ``build_splat_pipeline`` builds it from a method
config and ``train_splat`` is the CLI's training run; a checkpoint (one
``torch.save`` file, ``engine.trainer.write_checkpoint``) holds the
gaussians, the Adam moments and counts, the densification state, the step
and the generators' and camera order's states, so a resumed run continues
bit-equal. The multi-camera mesh step (the reference takes it only on a
mesh of more than one device) and LPIPS are not ported."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfstudio_torch.cameras.lie_groups import exp_map_SE3, exp_map_SO3xR3
from nerfstudio_torch.data.datamanagers import FullImageDatamanager
from nerfstudio_torch.data.undistort import undistort_view
from nerfstudio_torch.engine.optimizers import SplatAdam, splat_means_lr
from nerfstudio_torch.engine.trainer import aux_from_state, aux_state, read_checkpoint, write_checkpoint
from nerfstudio_torch.model_components.bilateral_grid import color_correct, slice_bilateral_grid
from nerfstudio_torch.models.splatfacto import InitDraws, SplatAux, SplatfactoModel, init_gaussian_params
from nerfstudio_torch.utils.math import clip
from nerfstudio_torch.utils.metrics import psnr, ssim
from nerfstudio_torch.utils.poses import multiply as pose_multiply


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
        """(reference :88-106) Fresh gaussians at ``max_gaussians`` slots, one
        bilateral grid and camera-opt tangent per training image where the
        config asks for them, and a fresh optimizer."""
        params, aux = init_gaussian_params(self.model.config, seed_points, scene_scale, generator=generator,
                                           draws=draws, device=device,
                                           num_images=self.datamanager.train_cameras.camera_to_worlds.shape[0])
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
        cam_idx: int = 0,
        noise: Optional[torch.Tensor] = None,
        means_lr: float = 0.0,
    ) -> Dict[str, torch.Tensor]:
        """One step (reference :162-254), in place on ``state``. c2w (3, 4),
        on the CPU or, under camera optimisation, best on the gaussians'
        device (no copy per step); ``background`` (3,) is the random
        background draw (None for the configured colour); ``cam_idx`` picks
        the image's camera-opt tangent and bilateral grid; ``noise`` (N, 3),
        MCMC's normal draw, moves the means after Adam at ``means_lr``.
        Returns the step's metrics as tensors."""
        cfg = self.model.config
        params = state.params
        aux = state.aux
        dev = params["means"].device
        probe = torch.zeros((params["means"].shape[0], 2), device=dev, requires_grad=True)
        if cfg.camera_optimizer_mode != "off":
            exp_map = exp_map_SE3 if cfg.camera_optimizer_mode == "SE3" else exp_map_SO3xR3
            # zero-mean gauge: a drift of every camera at once goes back into the world frame
            co = params["camera_opt"] - torch.mean(params["camera_opt"], dim=0, keepdim=True)
            c2w = pose_multiply(exp_map(co[cam_idx][None])[0], c2w.to(dev))
        outputs = self.model.render(params, aux.alive, c2w, K, width, height, sh_degree, background=background,
                                    means2d_probe=probe)
        if cfg.use_bilateral_grid:
            outputs["rgb_raw"] = outputs["rgb"]
            outputs["rgb"] = clip(slice_bilateral_grid(params["bilateral_grids"][cam_idx], outputs["rgb"]), 0.0, 1.0)
        loss, loss_dict = self.model.get_loss(outputs, gt_image, params, aux.alive)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        if cfg.strategy == "mcmc":
            if noise is None:
                raise ValueError("the mcmc strategy's step needs its (N, 3) noise draw")
            with torch.no_grad():
                params["means"].copy_(self.model.mcmc_noise(params, aux.alive, noise, means_lr))
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

    def refine_mcmc(self, state: SplatTrainState, src: torch.Tensor) -> SplatTrainState:
        """(reference :394-403) In place on ``state``; ``src`` (m,) the
        sources' draw (``mcmc_draws``)."""
        state.aux = self.model.refine_mcmc(state.params, state.optimizer, state.aux, src)
        return state

    def mcmc_draws(self, state: SplatTrainState, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The (m,) sources of one MCMC refine, drawn with replacement in
        proportion to ``model.mcmc_src_probs`` (the reference's
        ``jax.random.categorical``)."""
        m = min(self.model.config.max_refine_new, state.params["means"].shape[0])
        return torch.multinomial(self.model.mcmc_src_probs(state.params, state.aux), m, replacement=True,
                                 generator=generator)

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

    def train(self, state: SplatTrainState, num_iterations: int, generator: Optional[torch.Generator] = None,
              writer=None, ckpt_dir: Optional[Path] = None, steps_per_save: int = 0,
              only_latest: bool = True):
        """Steps ``state.step`` to ``num_iterations - 1`` with the refine
        schedule (reference :511-651): the default strategy's, or MCMC's
        while ``step < stop_split_at``. Each step draws its background from
        ``generator`` when the config asks for a random one, then, under
        MCMC, its (N, 3) position noise; each refine draws its two normal
        draws or its MCMC sources. Every 50 steps the metrics go to
        ``writer``; every ``steps_per_save`` steps a checkpoint to
        ``ckpt_dir``. Returns (state, the last step's metrics)."""
        cfg = self.model.config
        dm = self.datamanager
        metrics = None
        c2w_dev = None
        if cfg.camera_optimizer_mode != "off":  # the corrected pose is made on the card: no copy per step
            c2w_dev = dm.train_cameras.camera_to_worlds.to(state.params["means"].device)
        for step in range(state.step, num_iterations):
            d = self.model.downscale_at(step)
            cam_idx, image = dm.next_train(step)
            c2w, K, w, h = self.camera(dm.train_cameras, cam_idx, d)
            if d > 1:
                # the reference's jax.image.resize "linear" (antialiased)
                image = F.interpolate(image.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                                      antialias=True, align_corners=False)[0].permute(1, 2, 0)
            background = noise = None
            dev = generator.device if generator is not None else image.device
            if cfg.background_color == "random":
                background = torch.rand((3,), generator=generator, device=dev).to(image.device)
            if cfg.strategy == "mcmc":
                noise = torch.randn(tuple(state.params["means"].shape), generator=generator, device=dev)
            if c2w_dev is not None:
                c2w = c2w_dev[cam_idx]
            metrics = self.train_step(state, c2w, K, image, background, w, h, self.model.sh_degree_at(step),
                                      cam_idx=cam_idx, noise=noise, means_lr=splat_means_lr(step, self.max_steps))
            if step > cfg.warmup_length and step % cfg.refine_every == 0:
                if cfg.strategy == "mcmc":
                    if step < cfg.stop_split_at:
                        self.refine_mcmc(state, self.mcmc_draws(state, generator))
                else:
                    reset_period = cfg.reset_alpha_every * cfg.refine_every
                    self.refine(
                        state, self.refine_draws(generator),
                        do_split=step < cfg.stop_split_at,
                        do_cull_scale=step > reset_period,
                        reset_alpha=step % reset_period == 0 and step < cfg.stop_split_at,
                        use_screen_size=reset_period < step < cfg.stop_screen_size_at,
                    )
            if writer is not None and step % 50 == 0:
                writer.put_dict("train", {k: float(v) for k, v in metrics.items()}, step)
            if ckpt_dir is not None and steps_per_save and (step + 1) % steps_per_save == 0:
                self.save_checkpoint(state, ckpt_dir, step + 1, generator, only_latest)
        return state, metrics

    # ------------------------------------------------------------------
    def save_checkpoint(self, state: SplatTrainState, ckpt_dir: Path, step: int,
                        generator: Optional[torch.Generator] = None, only_latest: bool = True) -> None:
        """(reference :435-452) One file at ``step``: the gaussians, the Adam
        state, the densification state, the step, the generator's state and
        the camera order's."""
        write_checkpoint(ckpt_dir, step, {
            "step": state.step, "params": {k: v.detach() for k, v in state.params.items()},
            "optimizer": state.optimizer.state_dict(), "aux": aux_state(state.aux),
            "generator": None if generator is None else generator.get_state(),
            "datamanager": self.datamanager.rng_state(),
        }, only_latest)

    def load_checkpoint(self, state: SplatTrainState, ckpt_dir: Path, step: Optional[int] = None,
                        generator: Optional[torch.Generator] = None) -> SplatTrainState:
        """(reference :454-508) ``state`` (and ``generator``) set in place from
        the checkpoint at ``step`` (None: the latest)."""
        step, payload = read_checkpoint(ckpt_dir, step)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(payload["params"][k])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.aux = aux_from_state(state.aux, payload["aux"], state.params["means"].device)
        state.step = int(payload["step"])
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"])
        if payload["datamanager"] is not None:
            self.datamanager.set_rng_state(payload["datamanager"])
        print(f"loaded splat checkpoint at step {step} from {ckpt_dir}", flush=True)
        return state

    # ------------------------------------------------------------------
    def _eval_background(self) -> Optional[torch.Tensor]:
        """A fixed eval background for a random training background: the
        eval dataset's alpha colour where it has one, else black (reference
        :670-685); None (the configured colour) otherwise."""
        if self.model.config.background_color != "random":
            return None
        dev = self.datamanager.train_images.device
        alpha_color = getattr(self.datamanager.eval_dataset, "alpha_color", None)
        return torch.zeros((3,), device=dev) if alpha_color is None else alpha_color.to(dev, torch.float32)

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
        return self._image_metrics(out, camera_idx, self.model.config.use_bilateral_grid), out

    def _image_metrics(self, out: Dict[str, torch.Tensor], camera_idx: int,
                       color_corrected: bool = False) -> Dict[str, float]:
        """PSNR and SSIM against the view's ground truth, undistorted on the
        host first where its camera carries distortion (the render is a
        pinhole's; reference :687-705), of the render colour-corrected to it
        with ``color_corrected`` (a config that trains bilateral grids)."""
        gt = self.datamanager.eval_image(camera_idx)
        cams = self.datamanager.eval_cameras
        if cams.distorted:
            gt = torch.from_numpy(undistort_view(gt.cpu().numpy(), cams, camera_idx)).to(gt.device)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + out["background"] * (1 - gt[..., 3:])
        pred = out["rgb"]
        if color_corrected:
            # eval views have no learned grid: fit the colours post hoc (reference :708-714)
            pred = color_correct(pred, gt)
        return {"psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt))}

    def get_average_eval_image_metrics(self, state: SplatTrainState) -> Dict[str, float]:
        """Every eval view's PSNR, SSIM and render rays/s and fps, mean and
        std, after one untimed render per image size (reference
        base_pipeline.py:384-414)."""
        from nerfstudio_torch.pipelines.base_pipeline import average_metrics

        cams, dev = self.datamanager.eval_cameras, self.datamanager.train_images.device
        n = cams.camera_to_worlds.shape[0]
        seen = set()
        for i in range(n):
            if (hw := (int(cams.height[i, 0]), int(cams.width[i, 0]))) not in seen:
                seen.add(hw)
                self.render_eval_image(state, i)
        all_metrics = []
        for i in range(n):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = self.render_eval_image(state, i)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0  # the render alone, as the ray pipeline times it
            h, w = out["rgb"].shape[:2]
            all_metrics.append({**self._image_metrics(out, i, self.model.config.use_bilateral_grid),
                                "num_rays_per_sec": h * w / dt, "fps": 1.0 / dt})
        return average_metrics(all_metrics)


def build_splat_pipeline(config) -> Tuple[SplatPipeline, SplatTrainState]:
    """A splatfacto method config as (pipeline, state) (reference
    :729-750): seeded from the train split's ``points3D_xyz``/``_rgb`` where
    the parser gives them, ``scene_scale`` the aabb's largest coordinate,
    the init's draws from a generator seeded with ``config.seed``."""
    from nerfstudio_torch.pipelines.factory import build_datasets

    device = config.machine.device()
    config.model.check_ported()
    train_ds, eval_ds, train_out = build_datasets(config)
    dm = FullImageDatamanager.from_datasets(config.datamanager, train_ds, eval_ds, device)
    scene_scale = float(train_out.scene_box.aabb.max())
    model = SplatfactoModel(config.model, scene_scale=scene_scale)
    pipeline = SplatPipeline(dm, model, max_steps=config.trainer.max_num_iterations)
    md = train_out.metadata
    seed_pts = None
    if md.get("points3D_xyz") is not None:
        rgb = md.get("points3D_rgb")
        seed_pts = (md["points3D_xyz"].numpy(), None if rgb is None else rgb.numpy())
    gen = torch.Generator(device=device).manual_seed(config.seed)
    return pipeline, pipeline.init_state(seed_points=seed_pts, scene_scale=scene_scale, generator=gen, device=device)


def train_splat(config) -> Tuple[SplatPipeline, SplatTrainState]:
    """A whole splatfacto run, the CLI's path for splatfacto (reference
    :753-771): resume from ``trainer.load_dir`` when set, train with
    checkpoints every ``trainer.steps_per_save`` steps, save at the end and
    print the first eval view's metrics."""
    from nerfstudio_torch.utils.writer import EventWriter

    pipeline, state = build_splat_pipeline(config)
    tcfg = config.trainer
    base = tcfg.get_base_dir()
    ckpt_dir = tcfg.get_checkpoint_dir(base)
    gen = torch.Generator(device=state.params["means"].device).manual_seed(config.seed)
    if tcfg.load_dir is not None:
        pipeline.load_checkpoint(state, tcfg.load_dir, tcfg.load_step, generator=gen)
    state, _ = pipeline.train(state, tcfg.max_num_iterations, gen, writer=EventWriter(base, vis=tcfg.vis),
                              ckpt_dir=ckpt_dir, steps_per_save=tcfg.steps_per_save,
                              only_latest=tcfg.save_only_latest_checkpoint)
    pipeline.save_checkpoint(state, ckpt_dir, state.step, gen, tcfg.save_only_latest_checkpoint)
    metrics, _ = pipeline.get_eval_image_metrics(state, 0)
    print("eval:", metrics, flush=True)
    print(f"training finished; checkpoints in {ckpt_dir}", flush=True)
    return pipeline, state
