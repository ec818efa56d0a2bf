"""LPIPS perceptual metric over VGG16 features (counterpart of
``nerfstudio_tpu/utils/lpips.py``). Two modes, as there:

  * real weights: a ``.npz`` converted from torchvision's VGG16 and the
    lpips linear heads (``tools/convert_lpips_weights.py``), named by the
    ``NST_LPIPS_WEIGHTS`` environment variable; reported as ``lpips``.
  * random VGG: the full VGG16/LPIPS architecture with He-initialised
    filters drawn from ``np.random.default_rng(20260819)`` in the
    reference's order (bit-identical to its filters) and uniform linear
    heads; reported as ``lpips_rand_vgg``, never comparable to published
    LPIPS numbers.

The convolutions (``F.conv2d``, "same" padding) and 2x2 max pools
(``F.max_pool2d``, floor) run in full float32: TF32 is turned off around
them and restored after, as the reference asks for HIGHEST precision."""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG16 "features": conv widths and the pools ("M"); LPIPS taps
# the relu after convs 1, 3, 6, 9 and 12 (relu1_2, relu2_2, relu3_3,
# relu4_3, relu5_3)
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
_VGG16_TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)
# LPIPS input normalisation (its "scaling layer")
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
RAND_VGG_SEED = 20260819


def _vgg16_taps(x: torch.Tensor, params: Dict[str, torch.Tensor]) -> list:
    """x: (1, 3, H, W) in [-1, 1] -> the five tapped relu outputs."""
    shift = torch.from_numpy(_SHIFT).to(x.device).reshape(1, 3, 1, 1)
    scale = torch.from_numpy(_SCALE).to(x.device).reshape(1, 3, 1, 1)
    x = (x - shift) / scale
    taps = []
    conv_i = 0
    for c in _VGG16_CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(F.conv2d(x, params[f"conv{conv_i}_w"], params.get(f"conv{conv_i}_b"), padding=1))
            if conv_i in _VGG16_TAPS:
                taps.append(x)
            conv_i += 1
    return taps


def _normalize(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.sqrt(torch.sum(feat**2, dim=1, keepdim=True) + 1e-10)


def lpips_with(pred: torch.Tensor, target: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """LPIPS of (H, W, 3) images in [0, 1] under ``params`` (tensors on the
    images' device) (reference ``_lpips_real``, :69-84)."""

    def prep(img):
        return (img * 2.0 - 1.0).permute(2, 0, 1)[None]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        fp = _vgg16_taps(prep(pred), params)
        ft = _vgg16_taps(prep(target), params)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    total = 0.0
    for i, (a, b) in enumerate(zip(fp, ft)):
        d = (_normalize(a) - _normalize(b)) ** 2
        total = total + torch.mean(torch.sum(d * params[f"lin{i}_w"], dim=1))
    return total


@functools.lru_cache(maxsize=1)
def rand_vgg_arrays() -> Dict[str, np.ndarray]:
    """The random-VGG mode's filters and heads as numpy arrays, drawn as
    the reference draws them (reference :107-128)."""
    rng = np.random.default_rng(RAND_VGG_SEED)
    params = {}
    cin = 3
    conv_i = 0
    for c in _VGG16_CFG:
        if c == "M":
            continue
        fan_in = cin * 9
        params[f"conv{conv_i}_w"] = rng.standard_normal((c, cin, 3, 3)).astype(np.float32) * np.sqrt(2.0 / fan_in)
        params[f"conv{conv_i}_b"] = np.zeros((c,), np.float32)
        cin = c
        conv_i += 1
    for i, ch in enumerate(_TAP_CHANNELS):
        params[f"lin{i}_w"] = np.full((1, ch, 1, 1), 1.0 / ch, np.float32)
    return params


def weights_path() -> Optional[Path]:
    """The real weights' ``.npz`` named by ``NST_LPIPS_WEIGHTS``, where it is a file."""
    env = os.environ.get("NST_LPIPS_WEIGHTS")
    return Path(env) if env and Path(env).is_file() else None


@functools.lru_cache(maxsize=4)
def _params_on(path: Optional[Path], device: str) -> Dict[str, torch.Tensor]:
    """The weights of ``path`` (None: the random VGG) as float32 tensors on
    ``device``, loaded once per (path, device)."""
    if path is None:
        arrays = rand_vgg_arrays()
    else:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def lpips_fn() -> Tuple[Callable[[torch.Tensor, torch.Tensor], torch.Tensor], str]:
    """(metric_fn, metric_name): "lpips" where ``NST_LPIPS_WEIGHTS`` names
    a weights file, else "lpips_rand_vgg" (reference :152-163). The
    function takes (H, W, 3) images in [0, 1] on any device."""
    path = weights_path()

    def fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return lpips_with(pred, target, _params_on(path, str(pred.device)))

    return fn, "lpips" if path is not None else "lpips_rand_vgg"


def eval_lpips(pred: torch.Tensor, gt: torch.Tensor) -> Dict[str, float]:
    """The eval's LPIPS entry under the reference's rule
    (``pipelines/base_pipeline.py:368-376``, ``splat_pipeline.py:719-725``):
    ``lpips`` where real weights load, ``lpips_rand_vgg`` only with
    ``NST_LPIPS_FALLBACK_METRIC=1`` (the random VGG is a weak perceptual
    signal), else nothing."""
    fn, name = lpips_fn()
    if name == "lpips" or os.environ.get("NST_LPIPS_FALLBACK_METRIC") == "1":
        return {name: float(fn(pred, gt))}
    return {}
