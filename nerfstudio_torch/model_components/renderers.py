"""Renderers (counterpart of ``nerfstudio_tpu/model_components/renderers.py``):
composite per-sample (..., num_samples, C) quantities along rays."""

from __future__ import annotations

from typing import Literal, Optional

import torch

_COLORS = {"black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0)}


def render_rgb(
    rgb: torch.Tensor,
    weights: torch.Tensor,
    background_color: Literal["last_sample", "black", "white"] = "last_sample",
    return_background: bool = False,
):
    """Weighted-sum compositing + background fill (reference :61-85).

    rgb: (..., S, 3); weights: (..., S, 1) -> (..., 3), and the background
    used with ``return_background``. The random background and the
    override context are not ported."""
    comp = torch.sum(weights * rgb, dim=-2)
    accumulation = torch.sum(weights, dim=-2)
    if background_color == "last_sample":
        bg = rgb[..., -1, :]
    elif background_color in _COLORS:
        bg = torch.tensor(_COLORS[background_color], device=comp.device)
    else:
        raise NotImplementedError(f"background {background_color!r} is not ported")
    out = comp + bg * (1.0 - accumulation)
    if return_background:
        return out, bg
    return out


def blend_background_for_loss_computation(
    pred_image: torch.Tensor,
    gt_image: torch.Tensor,
    background: Optional[torch.Tensor] = None,
    background_color="black",
):
    """(pred, gt) for the rgb loss (reference :97-120): an RGBA ground truth
    is blended over a concrete colour, so the background is supervised:
    ``background`` (the colour the renderer used) where given, else
    ``background_color`` (a name or an RGB triple; ``last_sample`` and
    ``random`` blend over black). RGB passes as is."""
    if gt_image.shape[-1] != 4:
        return pred_image, gt_image
    alpha = gt_image[..., 3:]
    if background is not None:
        bg = background
    elif background_color in ("last_sample", "random"):
        bg = torch.zeros_like(pred_image)
    elif isinstance(background_color, str):
        if background_color not in _COLORS:
            raise ValueError(f"background colour {background_color!r}")
        bg = torch.tensor(_COLORS[background_color], dtype=pred_image.dtype, device=pred_image.device)
    else:
        bg = torch.as_tensor(background_color, dtype=pred_image.dtype, device=pred_image.device)
    return pred_image, gt_image[..., :3] * alpha + bg * (1.0 - alpha)


def render_normals(normals: torch.Tensor, weights: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Weighted sum of per-sample normals, normalised (reference :182-187)."""
    n = torch.sum(weights * normals, dim=-2)
    if normalize:
        n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-10)
    return n


def render_semantics(semantics: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-class logits composited along the ray (reference :177-179)."""
    return torch.sum(weights * semantics, dim=-2)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """(reference :139-141)"""
    return torch.sum(weights, dim=-2)


def render_depth(
    weights: torch.Tensor,
    ray_samples,
    method: Literal["median", "expected"] = "median",
) -> torch.Tensor:
    """Depth compositing (reference :144-169).

    median: the first sample where the cumulative weight reaches 0.5.
    expected: the weight-normalised mean, clipped to the smallest first and
    largest last sample midpoint over the WHOLE batch (not per ray), as the
    reference does, so chunking changes it."""
    steps = (ray_samples.frustums.starts + ray_samples.frustums.ends) / 2  # (..., S, 1)
    if method == "expected":
        eps = 1e-10
        depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + eps)
        return torch.clamp(depth, steps[..., 0, :].min(), steps[..., -1, :].max())
    if method == "median":
        cum = torch.cumsum(weights[..., 0], dim=-1).contiguous()  # (..., S)
        split = torch.full(cum.shape[:-1] + (1,), 0.5, dtype=cum.dtype, device=cum.device)
        idx = torch.searchsorted(cum, split, side="left")
        idx = torch.clamp(idx, 0, steps.shape[-2] - 1)
        return torch.gather(steps[..., 0], -1, idx)
    raise ValueError(method)
