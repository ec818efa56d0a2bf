"""ctypes binding of ``csrc/gsplat.cu`` (K4, K5, K6) and its launch counts.

The library is built with ``nvcc`` at first CUDA use (``ops/cuda_build``).
Every wrapper counts its launches here, where the kernel is launched, so a
run can show that the main path went through the kernels."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# Launches of each hand-written kernel entry. K4's backward counts once
# more under "project_gaussians_bwd_viewmat" when the same launch also
# summed the viewmat's gradient. K5 counts one binning under
# "tile_bin" in either design, and once more under "tile_bin_bucketed" when
# it took the tile-bucketed design (its count, scan, scatter and per-tile
# sort kernels, launched by one C entry) or under "tile_bin_sorted" when it
# took the sorted one (frames above the bucketed design's tile limit). K6's forward counts one launch
# under "blend_saturating" in either design, and once more under
# "blend_saturating_per_pixel" when it took the per-pixel design.
launch_counts: Dict[str, int] = {
    "project_gaussians": 0,
    "project_gaussians_bwd": 0,
    "project_gaussians_bwd_viewmat": 0,
    "tile_bin": 0,
    "tile_bin_bucketed": 0,
    "tile_bin_sorted": 0,
    "blend_saturating": 0,
    "blend_saturating_per_pixel": 0,
    "blend_saturating_bwd": 0,
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from nerfstudio_torch.ops import cuda_build

        lib = cuda_build.load("gsplat")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        cam = ctypes.POINTER(ctypes.c_float)
        signatures = {
            "nst_gsplat_project_fwd": [p, p, p, cam, p, i, i, i, ll] + [p] * 6 + [p],
            "nst_gsplat_project_bwd": [p, p, p, cam, p, i, i, i, ll] + [p] * 9 + [p],
            "nst_gsplat_tile_keys": [p, p, p, p, ll, p, ll, i, i, i, i, i, i, p, p],
            "nst_gsplat_tile_bin": [p, p, p, p, ll, p, ll, i, i, i, i, i, i, i] + [p] * 6 + [p],
            "nst_gsplat_tile_ranges": [p, ll, i, i, i, i, p, p, p, p],
            "nst_gsplat_blend_fwd": [p] * 7 + [i] * 5 + [p] * 3 + [p],
            "nst_gsplat_blend_bwd": [p] * 7 + [i] * 4 + [p] * 4 + [p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nst_gsplat_project_bwd_scratch.argtypes = []
        lib.nst_gsplat_project_bwd_scratch.restype = ll
        lib.nst_gsplat_error_string.argtypes = [ctypes.c_int]
        lib.nst_gsplat_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(name: Optional[str], fn: str, device: torch.device, *args) -> None:
    """Call a C entry on the current stream of ``device``, raise on a refused
    launch, and count it under ``name`` (None: counted by the caller)."""
    lib = kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.nst_gsplat_error_string(err).decode()}")
    if name is not None:
        launch_counts[name] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
