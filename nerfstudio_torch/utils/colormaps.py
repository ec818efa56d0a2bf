"""Colormaps for rendered outputs (counterpart of
``nerfstudio_tpu/utils/colormaps.py``): turbo, viridis and grey maps of a
scalar image, the depth map over its range composited by accumulation, a
boolean map and the PCA map of a feature image. Plain PyTorch ops on the
image's device, float32."""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch

ColormapOptions = Literal["default", "turbo", "viridis", "gray", "pca"]

# piecewise-sampled turbo colormap anchors (matplotlib-compatible, 16 stops)
_TURBO = np.array(
    [
        [0.18995, 0.07176, 0.23217], [0.25107, 0.25237, 0.63374],
        [0.27628, 0.42118, 0.89123], [0.25862, 0.57958, 0.99876],
        [0.15844, 0.73551, 0.92305], [0.09267, 0.86554, 0.7623],
        [0.19659, 0.94901, 0.59466], [0.42778, 0.99419, 0.38575],
        [0.64362, 0.98999, 0.23356], [0.80473, 0.92452, 0.20459],
        [0.93301, 0.81236, 0.22667], [0.99314, 0.67408, 0.20348],
        [0.9836, 0.49291, 0.12849], [0.92105, 0.31489, 0.05475],
        [0.81608, 0.18462, 0.01809], [0.66449, 0.08436, 0.00424],
    ],
    dtype=np.float32,
)

# viridis anchors (matplotlib-compatible, 16 stops)
_VIRIDIS = np.array(
    [
        [0.26700, 0.00487, 0.32942], [0.28192, 0.08966, 0.41241],
        [0.28026, 0.16560, 0.47699], [0.26366, 0.23763, 0.51877],
        [0.23744, 0.30500, 0.54192], [0.20862, 0.36775, 0.55267],
        [0.18225, 0.42618, 0.55711], [0.15870, 0.48237, 0.55789],
        [0.13777, 0.53780, 0.55459], [0.12115, 0.59274, 0.54465],
        [0.12808, 0.64775, 0.52345], [0.18065, 0.70140, 0.48819],
        [0.27415, 0.75198, 0.43686], [0.39517, 0.79747, 0.36775],
        [0.53561, 0.83578, 0.28188], [0.68895, 0.86545, 0.18272],
    ],
    dtype=np.float32,
)


def apply_colormap(
    image: torch.Tensor,
    colormap: ColormapOptions = "turbo",
    normalize: bool = False,
    eps: float = 1e-9,
) -> torch.Tensor:
    """(..., 1) scalar image -> (..., 3) colour, linear between the map's 16
    anchors; a (..., 3) image passes through (reference :46-67)."""
    if image.shape[-1] == 3:
        return image
    x = image[..., 0]
    if normalize:
        x = (x - x.min()) / torch.clamp_min(x.max() - x.min(), eps)
    x = torch.clamp(x, 0.0, 1.0)
    if colormap == "gray":
        return x[..., None].repeat_interleave(3, dim=-1)
    anchors = torch.from_numpy(_VIRIDIS if colormap == "viridis" else _TURBO).to(x.device)
    n = anchors.shape[0]
    t = x * (n - 1)
    i0 = torch.clamp(torch.floor(t).to(torch.int32), 0, n - 2).long()
    frac = (t - i0)[..., None]
    return anchors[i0] * (1 - frac) + anchors[i0 + 1] * frac


def apply_depth_colormap(
    depth: torch.Tensor,
    accumulation: Optional[torch.Tensor] = None,
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
    colormap: ColormapOptions = "turbo",
) -> torch.Tensor:
    """(..., 1) depth over [near, far] (the image's range where not given)
    -> (..., 3), composited over white by ``accumulation`` (reference
    :70-84). The range's ends round to float32, as the reference's weakly
    typed scalars do."""
    near = near_plane if near_plane is not None else float(depth.min())
    far = far_plane if far_plane is not None else float(depth.max())

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=depth.device)

    d = (depth - f32(near)) / f32(max(far - near, 1e-10))
    colored = apply_colormap(torch.clamp(d, 0.0, 1.0), colormap=colormap)
    if accumulation is not None:
        colored = colored * accumulation + (1.0 - accumulation)
    return colored


def apply_boolean_colormap(
    image: torch.Tensor, true_color=(1.0, 1.0, 1.0), false_color=(0.0, 0.0, 0.0)
) -> torch.Tensor:
    """(..., 1) bool -> (..., 3) of the two colours (reference :87-94)."""
    t = torch.tensor(true_color, dtype=torch.float32, device=image.device)
    f = torch.tensor(false_color, dtype=torch.float32, device=image.device)
    return torch.where(image, t, f)


def apply_pca_colormap(image: torch.Tensor) -> torch.Tensor:
    """(..., C) features -> (..., 3): the first three principal components,
    each over its 1st-99th percentile range (reference :97-105). An SVD's
    signs are not defined, so a channel may come out as 1 - c against
    another LAPACK's."""
    flat = image.reshape(-1, image.shape[-1])
    centered = flat - flat.mean(dim=0)
    _, _, vh = torch.linalg.svd(centered, full_matrices=False)
    proj = centered @ vh[:3].T
    lo = torch.quantile(proj, 0.01, dim=0)
    hi = torch.quantile(proj, 0.99, dim=0)
    proj = torch.clamp((proj - lo) / torch.clamp_min(hi - lo, 1e-9), 0, 1)
    return proj.reshape(image.shape[:-1] + (3,))
