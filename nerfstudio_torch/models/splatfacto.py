"""Splatfacto, 3D Gaussian Splatting (counterpart of
``nerfstudio_tpu/models/splatfacto.py``).

As in the reference, the gaussians live in padded tensors of
``max_gaussians`` rows with an ``alive`` mask, and densification
(DefaultStrategy: clone, split, cull, opacity reset) rewrites slots of those
tensors, so ``refine`` matches the reference slot for slot; the MCMC
strategy (``refine_mcmc``, relocation and growth, and ``mcmc_noise``, the
per-step position noise) rewrites them the same way. The tensors are
updated in place, so the optimizer keeps its references. Rendering is K4
projection, SH colour, K5 binning and the K6 saturating blend
(``ops/gsplat``). Beside the gaussians a config may ask for one bilateral
grid and one camera-opt tangent per training image (``bilateral_grids``,
``camera_opt``); the loss adds scale, TV and the MCMC regularisers as
configured.

Not ported: ``blend_mode="bounded"``; a config asking for it raises."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.model_components.bilateral_grid import bilateral_grid_tv_loss, init_bilateral_grid
from nerfstudio_torch.models.base_model import ModelConfig
from nerfstudio_torch.ops.gsplat.projection import get_viewmat, project_gaussians, quat_to_rotmat
from nerfstudio_torch.ops.gsplat.rasterize import rasterize
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.math import k_nearest_neighbors, random_quat
from nerfstudio_torch.utils.metrics import psnr, ssim
from nerfstudio_torch.utils.spherical_harmonics import eval_sh, num_sh_bases, rgb_to_sh

GAUSSIAN_ARRAYS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")
# one row per training image, made when the config asks for them, in this order
IMAGE_ARRAYS = ("bilateral_grids", "camera_opt")


@dataclasses.dataclass
class SplatfactoModelConfig(ModelConfig):
    """(reference splatfacto.py:36-104; every field, same defaults)"""

    warmup_length: int = 500
    refine_every: int = 100
    resolution_schedule: int = 3000
    num_downscales: int = 2
    background_color: Literal["random", "black", "white"] = "random"
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.00005
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    stop_split_at: int = 15000
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    rasterize_mode: Literal["classic", "antialiased"] = "classic"
    strategy: Literal["default", "mcmc"] = "default"
    mcmc_noise_lr: float = 5e5
    mcmc_opacity_reg: float = 0.01
    mcmc_scale_reg: float = 0.01
    mcmc_min_opacity: float = 0.005
    mcmc_grow_factor: float = 1.05
    random_init: bool = False
    num_random: int = 50000
    random_scale: float = 10.0
    use_bilateral_grid: bool = False
    bilateral_grid_shape: Tuple[int, int, int] = (8, 16, 16)
    bilateral_tv_loss_mult: float = 10.0
    camera_optimizer_mode: Literal["off", "SO3xR3", "SE3"] = "off"
    ssim_lambda: float = 0.2
    max_gaussians: int = 300000
    max_refine_new: int = 8192
    tiles_per_gauss: int = 16
    max_per_tile: int = 512
    tile_chunk: int = 64
    big_frac: int = 16
    big_tiles_per_gauss: int = 64
    blend_mode: str = "saturating"
    blend_chunk_size: int = 64
    near_plane: float = 0.01

    def __post_init__(self):
        if self._target is None:
            self._target = SplatfactoModel

    def check_ported(self) -> None:
        """Raise on the options this port does not have yet."""
        if self.blend_mode != "saturating":
            raise NotImplementedError(f"splatfacto options not ported: blend_mode={self.blend_mode!r}")


@dataclasses.dataclass
class SplatAux:
    """Densification state (reference :111-116), all (N,)."""

    alive: torch.Tensor  # bool
    grad_accum: torch.Tensor  # accumulated ||dL/dmeans2d||
    grad_count: torch.Tensor  # views where visible
    max_radii: torch.Tensor  # max screen radius seen, as a fraction of the larger image side


@dataclasses.dataclass
class InitDraws:
    """The random draws of ``init_gaussian_params``: random-init points
    (n, 3) and colours (n, 3) uniform in [0, 1) (colours also for seed points
    without colour), and the quaternions' (3, n) uniforms."""

    points: Optional[torch.Tensor]
    rgb: Optional[torch.Tensor]
    quat_uniforms: torch.Tensor


def init_gaussian_params(
    config: SplatfactoModelConfig,
    seed_points: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
    scene_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[InitDraws] = None,
    device=None,
    num_images: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], SplatAux]:
    """Seed points (or random points) with kNN scale init, padded to
    ``max_gaussians`` slots (reference :136-201). Draws come from ``draws``
    when given, else from ``generator`` on ``device``. The per-image arrays
    the config asks for, identity bilateral grids (num_images, 12, W, Y, X)
    and zero camera-opt tangents (num_images, 6), need ``num_images``."""
    per_image = config.use_bilateral_grid or config.camera_optimizer_mode != "off"
    if per_image and num_images is None:
        raise ValueError("the bilateral grid and camera-opt keep arrays per image: pass num_images")
    n_cap = config.max_gaussians
    device = resolve_device(device)
    use_seed = seed_points is not None and not config.random_init and len(seed_points[0]) > 0
    n = len(seed_points[0]) if use_seed else config.num_random
    if draws is None:
        u = lambda *shape: torch.rand(shape, generator=generator, device=device)  # noqa: E731
        draws = InitDraws(None if use_seed else u(n, 3), u(n, 3), u(3, n))
    if use_seed:
        pts = torch.as_tensor(np.asarray(seed_points[0]), dtype=torch.float32, device=device)
        rgb = draws.rgb if seed_points[1] is None else torch.as_tensor(
            np.asarray(seed_points[1]), dtype=torch.float32, device=device) / 255.0
    else:
        pts = (draws.points.to(device) - 0.5) * config.random_scale * scene_scale
        rgb = draws.rgb
    n = min(n, n_cap)
    pts, rgb = pts[:n], rgb[:n].to(device)

    dists, _ = k_nearest_neighbors(pts, 3)
    avg_dist = torch.mean(dists, dim=-1, keepdim=True)
    scales_log = torch.log(torch.clamp_min(avg_dist, 1e-7)).repeat(1, 3)
    quats = random_quat(n, uniforms=draws.quat_uniforms[:, :n].to(device))
    dim_sh = num_sh_bases(config.sh_degree)

    def pad(x, fill=0.0):
        out = torch.full((n_cap,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=device)
        out[:n] = x
        return out

    quats = pad(quats)
    quats[n:, 0] = 1.0
    params = {
        "means": pad(pts),
        "scales": pad(scales_log),
        "quats": quats,
        "features_dc": pad(rgb_to_sh(rgb)),
        "features_rest": torch.zeros((n_cap, dim_sh - 1, 3), device=device),
        "opacities": pad(torch.full((n, 1), math.log(0.1 / 0.9), device=device), fill=-10.0),
    }
    if config.use_bilateral_grid:
        gw, gy, gx = config.bilateral_grid_shape
        params["bilateral_grids"] = init_bilateral_grid(num_images, gx, gy, gw, device=device)
    if config.camera_optimizer_mode != "off":
        params["camera_opt"] = torch.zeros((num_images, 6), device=device)
    aux = SplatAux(
        alive=torch.arange(n_cap, device=device) < n,
        grad_accum=torch.zeros((n_cap,), device=device),
        grad_count=torch.zeros((n_cap,), device=device),
        max_radii=torch.zeros((n_cap,), device=device),
    )
    return params, aux


def _top_m(score: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The m largest scores and their indices, ties lower index first, as
    XLA's TopK gives them (``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(score, descending=True, stable=True)
    return values[:m], idx[:m]


class SplatfactoModel:
    """Functional splatfacto: the parameters are a dict of tensors passed in."""

    def __init__(self, config: SplatfactoModelConfig, scene_scale: float = 1.0):
        config.check_ported()
        self.config = config
        self.scene_scale = scene_scale

    def render(
        self,
        params: Dict[str, torch.Tensor],
        alive: torch.Tensor,
        c2w: torch.Tensor,
        K: Tuple[float, float, float, float],
        width: int,
        height: int,
        sh_degree_active: int,
        background: Optional[torch.Tensor] = None,
        means2d_probe: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """(reference :212-282). c2w (3, 4) OpenGL: on the CPU (the projection
        reads its viewmat on the host), or, when it carries a gradient (a
        camera-opt corrected pose), on the gaussians' device, where K4 reads
        it and returns its gradient. K = (fx, fy, cx, cy). ``background`` (3,)
        is the reference's random draw when the config asks for one;
        without it the configured colour (black for "random") is used."""
        cfg = self.config
        fx, fy, cx, cy = K
        viewmat = get_viewmat(c2w) if c2w.requires_grad else get_viewmat(c2w.detach().cpu())
        means = params["means"]
        scales = torch.exp(params["scales"])
        opac = torch.sigmoid(params["opacities"][:, 0]) * alive
        antialiased = cfg.rasterize_mode == "antialiased"
        means2d, depths, conics, radii, valid, comp = project_gaussians(
            means, scales, params["quats"], viewmat, fx, fy, cx, cy, width, height, near=cfg.near_plane,
            antialiased=antialiased,
        )
        valid = valid & alive
        if means2d_probe is not None:
            means2d = means2d + means2d_probe
        if antialiased:
            opac = opac * comp

        cam_pos = c2w[:3, 3].to(means.device)
        viewdirs = means - cam_pos
        viewdirs = viewdirs / torch.clamp_min(torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True), 1e-8)
        n_bases = num_sh_bases(sh_degree_active)
        coeffs = torch.cat([params["features_dc"][:, None, :], params["features_rest"]], dim=1)[:, :n_bases]
        colors = torch.clamp_min(eval_sh(sh_degree_active, coeffs, viewdirs) + 0.5, 0.0)

        rgb, alpha, depth = rasterize(
            means2d, conics, colors, opac, depths, radii, valid, width=width, height=height,
            tiles_per_gauss=cfg.tiles_per_gauss, big_frac=cfg.big_frac, big_tiles_per_gauss=cfg.big_tiles_per_gauss,
        )
        if background is None:
            background = torch.full((3,), 1.0 if cfg.background_color == "white" else 0.0, device=means.device)
        rgb = rgb + background * (1.0 - alpha)
        return {
            "rgb": torch.clamp(rgb, 0.0, 1.0),
            "accumulation": alpha,
            "depth": depth,
            "background": background,
            "radii": radii,
            "visible": valid,
        }

    def get_loss(self, outputs, gt_image: torch.Tensor, params: Optional[Dict[str, torch.Tensor]] = None,
                 alive: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """L1 + SSIM, plus the regularisers the config turns on over
        ``params`` and the ``alive`` mask (reference :285-337): the scale
        ratio, the bilateral grids' TV and MCMC's opacity and scale terms."""
        cfg = self.config
        pred = outputs["rgb"]
        if gt_image.shape[-1] == 4:
            gt = gt_image[..., :3] * gt_image[..., 3:] + outputs["background"] * (1.0 - gt_image[..., 3:])
        else:
            gt = gt_image
        l1 = torch.mean(torch.abs(gt - pred))
        simloss = 1.0 - ssim(pred, gt)
        loss = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * simloss
        loss_dict = {"main_loss": loss, "l1": l1, "ssim_loss": simloss}
        if cfg.use_scale_regularization:
            scales = torch.exp(params["scales"])
            # amax/amin split the gradient between tied scales, as jnp.max does
            ratio = torch.amax(scales, dim=-1) / torch.clamp_min(torch.amin(scales, dim=-1), 1e-8)
            excess = torch.maximum(ratio, ratio.new_full((), cfg.max_gauss_ratio)) - cfg.max_gauss_ratio
            scale_reg = torch.mean(torch.where(alive, excess, torch.zeros_like(excess))) * 0.1
            loss_dict["scale_reg"] = scale_reg
            loss = loss + scale_reg
        if cfg.use_bilateral_grid:
            tv = cfg.bilateral_tv_loss_mult * bilateral_grid_tv_loss(params["bilateral_grids"])
            loss_dict["tv_loss"] = tv
            loss = loss + tv
        if cfg.strategy == "mcmc":
            n_alive = torch.clamp_min(torch.sum(alive.to(torch.float32)), 1.0)
            opac = torch.sigmoid(params["opacities"][:, 0])
            op_reg = cfg.mcmc_opacity_reg * torch.sum(torch.where(alive, opac, torch.zeros_like(opac))) / n_alive
            sc = torch.exp(params["scales"])
            sc_reg = cfg.mcmc_scale_reg * torch.sum(torch.where(alive[:, None], sc, torch.zeros_like(sc))) / (
                3.0 * n_alive)
            loss_dict["mcmc_opacity_reg"] = op_reg
            loss_dict["mcmc_scale_reg"] = sc_reg
            loss = loss + op_reg + sc_reg
        loss_dict["loss"] = loss
        loss_dict["gt"] = gt
        return loss, loss_dict

    @torch.no_grad()
    def refine(
        self,
        params: Dict[str, torch.Tensor],
        optimizer,
        aux: SplatAux,
        normals: Tuple[torch.Tensor, torch.Tensor],
        do_split: bool,
        do_cull_scale: bool,
        reset_alpha: bool,
        use_screen_size: bool = False,
    ) -> SplatAux:
        """One densify/cull pass (reference :340-475), in place on ``params``
        and the moments of ``optimizer`` (a ``SplatAdam``); returns the new
        aux. ``normals`` are the reference's two ``normal((m, 3))`` draws
        (m = min(max_refine_new, N)): the split offsets of the new and of the
        source gaussians."""
        cfg = self.config
        n_cap = params["means"].shape[0]
        m = min(cfg.max_refine_new, n_cap)
        eps1, eps2 = (e.to(params["means"].device) for e in normals)
        if eps1.shape != (m, 3) or eps2.shape != (m, 3):
            raise ValueError(f"refine needs two ({m}, 3) normal draws, got {tuple(eps1.shape)}, {tuple(eps2.shape)}")

        avg_grad = aux.grad_accum / torch.clamp_min(aux.grad_count, 1.0)
        max_scale = torch.max(torch.exp(params["scales"]), dim=-1).values
        high_grad = (avg_grad > cfg.densify_grad_thresh) & aux.alive
        is_small = max_scale <= cfg.densify_size_thresh * self.scene_scale
        clone_mask = high_grad & is_small
        big_for_split = ~is_small
        if use_screen_size:
            big_for_split = big_for_split | (aux.max_radii > cfg.split_screen_size)
        split_mask = high_grad & big_for_split & do_split

        opac = torch.sigmoid(params["opacities"][:, 0])
        cull = aux.alive & (opac < cfg.cull_alpha_thresh - 1e-4)
        if do_cull_scale:
            cull = cull | (aux.alive & (max_scale > cfg.cull_scale_thresh * self.scene_scale))
        if use_screen_size:
            cull = cull | (aux.alive & (aux.max_radii > cfg.cull_screen_size))
        alive = aux.alive & ~cull

        grow_mask = (clone_mask | split_mask) & alive
        top_score, src = _top_m(torch.where(grow_mask, avg_grad, torch.full_like(avg_grad, -1.0)), m)
        src_ok = top_score > 0.0
        _, free = _top_m((~alive).to(torch.float32), m)
        write_ok = src_ok & ~alive[free]
        src_is_split = split_mask[src]

        R = quat_to_rotmat(params["quats"][src])
        src_scales = params["scales"][src]
        src_means = params["means"][src]
        offset = torch.einsum("nij,nj->ni", R, eps1 * torch.exp(src_scales))
        new_means = torch.where(src_is_split[:, None], src_means + offset, src_means)
        new_scales = torch.where(src_is_split[:, None], src_scales - math.log(1.6), src_scales)
        offset2 = torch.einsum("nij,nj->ni", R, eps2 * torch.exp(src_scales))
        news = {"means": new_means, "scales": new_scales}
        news.update({k: params[k][src] for k in ("quats", "features_dc", "features_rest", "opacities")})

        def ok(mask, x):
            return mask.view((-1,) + (1,) * (x.ndim - 1))

        for name, vals in news.items():
            dst = params[name]
            dst[free] = torch.where(ok(write_ok, vals), vals, dst[free])
        # sources that split also shrink and move
        split_src_write = src_is_split & write_ok
        for name, vals in (("means", src_means + offset2), ("scales", new_scales)):
            dst = params[name]
            dst[src] = torch.where(ok(split_src_write, vals), vals, dst[src])
        new_alive = alive.clone()
        new_alive[free] = alive[free] | write_ok

        if reset_alpha:
            reset_val = math.log(cfg.cull_alpha_thresh * 2.0 / (1 - cfg.cull_alpha_thresh * 2.0))
            params["opacities"].clamp_(max=reset_val)

        # zero the moments of written slots and split sources; on a reset,
        # wipe the opacity moments whole (the count stays)
        touched = torch.zeros((n_cap,), dtype=torch.bool, device=alive.device)
        touched[free] = write_ok
        touched[src] = touched[src] | split_src_write
        optimizer.zero_rows(touched)
        if reset_alpha:
            optimizer.reset("opacities")
        zeros = torch.zeros_like(aux.grad_accum)
        return SplatAux(alive=new_alive, grad_accum=zeros, grad_count=zeros.clone(), max_radii=zeros.clone())

    # ------------------------------------------------------------------
    # MCMC strategy (gsplat MCMCStrategy, "3D Gaussian Splatting as MCMC";
    # reference :478-634)

    MCMC_N_MAX = 51  # the binomial table's bound (reference :478)

    @staticmethod
    def _relocation(opac_old: torch.Tensor, scales_old: torch.Tensor, ratios: torch.Tensor):
        """Splitting a gaussian into N copies (reference :485-518): new
        opacity 1 - (1 - o)^(1/N), new log scale + log(o / denom), denom from
        the 51x51 binomial table C(i - 1, k), all in float32. ratios (M,) int
        in [1, 51]."""
        n_max = SplatfactoModel.MCMC_N_MAX
        dev = opac_old.device
        ratios = torch.clamp(ratios, 1, n_max)
        o_new = 1.0 - torch.pow(torch.clamp(1.0 - opac_old, 1e-7, 1.0), 1.0 / ratios.to(torch.float32))
        binoms = torch.tensor([[float(math.comb(i, k)) if k <= i else 0.0 for k in range(n_max)]
                               for i in range(n_max)], dtype=torch.float32).to(dev)
        ks = torch.arange(n_max, dtype=torch.float32, device=dev)
        sign = 1.0 - 2.0 * torch.remainder(ks, 2.0)  # (-1)^k
        term = sign / torch.sqrt(ks + 1.0) * torch.pow(o_new[:, None], ks[None, :] + 1.0)
        inner = term @ binoms.t()  # inner[:, i - 1] = sum_k C(i - 1, k) term_k
        i_idx = torch.arange(1, n_max + 1, device=dev)
        denom = torch.sum(torch.where(i_idx[None, :] <= ratios[:, None], inner, torch.zeros_like(inner)), dim=-1)
        coeff = opac_old / torch.clamp_min(denom, 1e-8)
        return o_new, scales_old + torch.log(torch.clamp_min(coeff, 1e-8))[:, None]

    def mcmc_src_probs(self, params: Dict[str, torch.Tensor], aux: SplatAux) -> torch.Tensor:
        """(N,) weights of ``refine_mcmc``'s source draw: the reference's
        categorical over log(max(opacity, 1e-8)) among the live gaussians,
        as unnormalised probabilities (zero elsewhere)."""
        opac = torch.sigmoid(params["opacities"][:, 0].detach())
        live = aux.alive & ~(opac < self.config.mcmc_min_opacity)
        return torch.where(live, torch.clamp_min(opac, 1e-8), torch.zeros_like(opac))

    @torch.no_grad()
    def refine_mcmc(self, params: Dict[str, torch.Tensor], optimizer, aux: SplatAux, src: torch.Tensor) -> SplatAux:
        """One MCMC refine (reference :520-614), in place on ``params`` and
        the moments of ``optimizer``: the dead (opacity below
        ``mcmc_min_opacity``) and then the free slots, up to
        min(dead + growth, m) of them, become copies of the sources ``src``
        (m,), the reference's categorical draw (``mcmc_src_probs``), and
        each source with copies takes the relocated opacity and scale.
        Returns the new aux.

        A source drawn more than once is written once per draw, and where
        the draws straddle the end of the written slots they write
        different values; XLA's scatter keeps the last draw's, and so does
        this port (the last occurrence of each source in ``src``), on every
        device."""
        cfg = self.config
        n_cap = params["means"].shape[0]
        m = min(cfg.max_refine_new, n_cap)
        dev = params["means"].device
        src = src.to(dev, torch.long)
        if src.shape != (m,):
            raise ValueError(f"refine_mcmc needs ({m},) source indices, got {tuple(src.shape)}")

        opac = torch.sigmoid(params["opacities"][:, 0])
        dead = aux.alive & (opac < cfg.mcmc_min_opacity)
        live = aux.alive & ~dead
        n_live = torch.sum(live.to(torch.int32))
        grow = torch.full((), cfg.mcmc_grow_factor - 1.0, dtype=torch.float32, device=dev)
        n_grow = torch.clamp_max((n_live.to(torch.float32) * grow).to(torch.int32), m)
        n_write = torch.clamp_max(torch.sum(dead.to(torch.int32)) + n_grow, m)

        one = torch.ones_like(opac)
        dst_score = torch.where(dead, 2.0 * one, torch.where(~aux.alive, one, 0.0 * one))
        dst_top, dst = _top_m(dst_score, m)
        write_ok = (dst_top > 0.0) & (torch.arange(m, device=dev) < n_write)

        counts = torch.zeros((n_cap,), dtype=torch.int32, device=dev).index_add_(0, src, write_ok.to(torch.int32))
        ratios = counts[src] + 1
        o_new, s_new = self._relocation(opac[src], params["scales"][src], ratios)
        opac_logit_new = torch.log(o_new / torch.clamp_min(1.0 - o_new, 1e-7))[:, None]

        def ok(mask, x):
            return mask.view((-1,) + (1,) * (x.ndim - 1))

        news = {k: params[k][src] for k in ("means", "quats", "features_dc", "features_rest")}
        news.update(scales=s_new, opacities=opac_logit_new)
        for name, vals in news.items():
            dst_arr = params[name]
            dst_arr[dst] = torch.where(ok(write_ok, vals), vals, dst_arr[dst])
        # each source once, from its last draw (XLA's scatter order); a
        # written draw's source has copies (counts > 0), so it takes the
        # relocated values exactly where its last draw was written
        last = torch.full((n_cap,), -1, dtype=torch.long, device=dev).scatter_reduce_(
            0, src, torch.arange(m, device=dev), reduce="amax")
        is_last = last[src] == torch.arange(m, device=dev)
        u_src, u_touched = src[is_last], write_ok[is_last]
        for name, vals in (("scales", s_new[is_last]), ("opacities", opac_logit_new[is_last])):
            dst_arr = params[name]
            dst_arr[u_src] = torch.where(ok(u_touched, vals), vals, dst_arr[u_src])
        new_alive = aux.alive.clone()
        new_alive[dst] = aux.alive[dst] | write_ok

        touched = torch.zeros((n_cap,), dtype=torch.bool, device=dev)
        touched[dst] = write_ok
        touched[u_src] = touched[u_src] | u_touched
        optimizer.zero_rows(touched)
        zeros = torch.zeros_like(aux.grad_accum)
        return SplatAux(alive=new_alive, grad_accum=zeros, grad_count=zeros.clone(), max_radii=zeros.clone())

    def mcmc_noise(self, params: Dict[str, torch.Tensor], alive: torch.Tensor, eps: torch.Tensor,
                   means_lr: float) -> torch.Tensor:
        """The means after MCMC's per-step position noise (reference
        :616-634): means + lr * noise_lr * sigmoid(100 ((1 - o) - 0.995)) *
        R S^2 R^T eps on the alive gaussians; ``eps`` (N, 3) is the
        reference's normal draw."""
        cfg = self.config
        with torch.no_grad():
            opac = torch.sigmoid(params["opacities"][:, 0])
            gate = torch.sigmoid(100.0 * ((1.0 - opac) - 0.995))
            R = quat_to_rotmat(params["quats"])
            s2 = torch.exp(params["scales"]) ** 2
            eps = eps.to(R.device)
            rt_eps = R[:, 0, :] * eps[:, 0:1] + R[:, 1, :] * eps[:, 1:2] + R[:, 2, :] * eps[:, 2:3]  # R^T eps
            y = s2 * rt_eps
            cov_eps = R[:, :, 0] * y[:, 0:1] + R[:, :, 1] * y[:, 1:2] + R[:, :, 2] * y[:, 2:3]  # R y
            noise = cov_eps * (gate * alive)[:, None] * means_lr * cfg.mcmc_noise_lr
            return params["means"] + noise

    def sh_degree_at(self, step: int) -> int:
        """SH degree warm-up (reference :636-638)."""
        return min(step // self.config.sh_degree_interval, self.config.sh_degree)

    def downscale_at(self, step: int) -> int:
        """Coarse-to-fine resolution schedule (reference :640-645)."""
        cfg = self.config
        return 2 ** max(cfg.num_downscales - step // cfg.resolution_schedule, 0)

    @staticmethod
    def get_metrics(outputs, gt) -> Dict[str, torch.Tensor]:
        return {"psnr": psnr(outputs["rgb"], gt)}
