"""Renderers (counterpart of ``nerfstudio_tpu/model_components/renderers.py``):
composite per-sample (..., num_samples, C) quantities along rays, and the
background override the eval renders run under (``BACKGROUND_COLOR_OVERRIDE``,
set by ``background_color_override_context``)."""

from __future__ import annotations

import contextlib
from typing import Literal, Optional, Union

import torch

_COLORS = {"black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0)}

BackgroundColor = Union[Literal["random", "last_sample", "black", "white"], torch.Tensor]

# the colour every render composites over while set (reference :24-41)
BACKGROUND_COLOR_OVERRIDE: Optional[torch.Tensor] = None


@contextlib.contextmanager
def background_color_override_context(color: torch.Tensor):
    """Render over ``color`` (3,) inside the block, whatever the model's
    background (reference :33-41); the previous override comes back after."""
    global BACKGROUND_COLOR_OVERRIDE
    old = BACKGROUND_COLOR_OVERRIDE
    try:
        BACKGROUND_COLOR_OVERRIDE = color
        yield
    finally:
        BACKGROUND_COLOR_OVERRIDE = old


def get_background_color(background_color: BackgroundColor, shape, device,
                         generator: Optional[torch.Generator] = None,
                         draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The background of ``shape`` (..., 3) (reference :44-58): the override
    where one is set, else a named colour, an RGB triple, or for
    ``"random"`` uniform colours in [0, 1): ``draw`` (of ``shape``) where
    handed in, else drawn from ``generator``."""
    if BACKGROUND_COLOR_OVERRIDE is not None:
        return BACKGROUND_COLOR_OVERRIDE.to(device, torch.float32).expand(shape)
    if isinstance(background_color, str):
        if background_color in _COLORS:
            return torch.tensor(_COLORS[background_color], device=device).expand(shape)
        if background_color == "random":
            if draw is not None:
                if tuple(draw.shape) != tuple(shape):
                    raise ValueError(f"random background draw of shape {tuple(draw.shape)}, want {tuple(shape)}")
                return draw.to(device, torch.float32)
            if generator is None:
                raise ValueError("the random background needs a generator or a draw")
            return torch.rand(tuple(shape), generator=generator, device=device)
        raise ValueError(f"background colour {background_color!r}")
    return torch.as_tensor(background_color, dtype=torch.float32, device=device).expand(shape)


def render_rgb(
    rgb: torch.Tensor,
    weights: torch.Tensor,
    background_color: BackgroundColor = "last_sample",
    return_background: bool = False,
    generator: Optional[torch.Generator] = None,
    background: Optional[torch.Tensor] = None,
):
    """Weighted-sum compositing + background fill (reference :61-85).

    rgb: (..., S, 3); weights: (..., S, 1) -> (..., 3), and the background
    used (..., 3) with ``return_background``. The override replaces every
    background, ``last_sample`` too. ``"random"`` takes ``background`` (the
    draw, (..., 3)) or draws from ``generator``."""
    comp = torch.sum(weights * rgb, dim=-2)
    accumulation = torch.sum(weights, dim=-2)
    if isinstance(background_color, str) and background_color == "last_sample" and BACKGROUND_COLOR_OVERRIDE is None:
        bg = rgb[..., -1, :]
    else:
        bg = get_background_color(background_color, comp.shape, comp.device, generator, background)
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
