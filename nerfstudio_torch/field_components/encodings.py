"""Input encodings (counterpart of
``nerfstudio_tpu/field_components/encodings.py``): ``HashEncoding`` on the
block and flat layouts, ``SHEncoding``, ``NeRFEncoding`` (with mip-NeRF's
integrated branch) and TensoRF's ``TensorCPEncoding``, ``TensorVMEncoding``
and ``TriplaneEncoding`` over K8 (``ops/interp.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerfstudio_torch.model_components.ray_samplers import linspace
from nerfstudio_torch.ops.hash_grid import hash_encode, init_hash_table
from nerfstudio_torch.ops.interp import grid_sample_1d, grid_sample_2d
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.math import expected_sin
from nerfstudio_torch.utils.spherical_harmonics import components_from_spherical_harmonics


class HashEncoding(nn.Module):
    """Instant-NGP multiresolution hash grid (reference encodings.py:162-230).

    Every path reads the (L, S, 128) table. With neither flag it is the flat
    layout (K7, exact 8-corner trilerp, differentiable once). Otherwise the
    block layout: K1 (stochastic one-block trilerp, differentiable twice) or
    K3 (exact 8-corner trilerp, differentiable in the positions), picked by
    the mode on every call: K3
    only when ``block_exact`` is set and the module is in eval mode, K1
    otherwise, as the reference field's ``block_exact=hash_block and not
    train and exact_eval``. ``device`` None means the GPU
    (``utils.device.resolve_device``)."""

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 1024,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        hash_init_scale: float = 0.001,
        block: bool = False,
        block_exact: bool = False,
        device=None,
    ):
        super().__init__()
        self.num_levels = num_levels
        self.min_res = min_res
        self.max_res = max_res
        self.log2_hashmap_size = log2_hashmap_size
        self.features_per_level = features_per_level
        self.hash_init_scale = hash_init_scale
        self.block = block
        self.block_exact = block_exact
        self.hash_table = nn.Parameter(
            init_hash_table(num_levels, self.hash_table_size, features_per_level, hash_init_scale,
                            device=resolve_device(device))
        )

    @property
    def hash_table_size(self) -> int:
        return 2**self.log2_hashmap_size

    def get_out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.hash_table.uniform_(-self.hash_init_scale, self.hash_init_scale, generator=generator)

    def forward(self, in_tensor: torch.Tensor, bwd_levels=None, bwd_scale: float = 1.0) -> torch.Tensor:
        """``bwd_levels``/``bwd_scale``: the level-subsampled table backward
        of K1 (``ops.hash_grid.hash_encode``)."""
        flat = not (self.block or self.block_exact)
        exact = self.block_exact and not self.training
        return hash_encode(
            in_tensor.contiguous(),
            self.hash_table,
            num_levels=self.num_levels,
            min_res=self.min_res,
            max_res=self.max_res,
            hash_table_size=self.hash_table_size,
            block=not (exact or flat),
            block_exact=exact,
            bwd_levels=None if (exact or flat) else bwd_levels,
            bwd_scale=bwd_scale,
        )


class SHEncoding(nn.Module):
    """Spherical-harmonic direction encoding, levels <= 4 (reference :233-243)."""

    def __init__(self, levels: int = 4):
        super().__init__()
        self.levels = levels

    def get_out_dim(self) -> int:
        return self.levels**2

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        return components_from_spherical_harmonics(self.levels, in_tensor)


class NeRFEncoding(nn.Module):
    """Multiscale sinusoidal positional encoding (reference encodings.py:57-90):
    ``sin([s, s + pi/2])`` of ``s = 2 pi x * 2^linspace(min, max, n)`` per
    input dimension (dimension-major), the input appended last with
    ``include_input``. Given ``covs`` (..., D, D), mip-NeRF's integrated
    encoding: each sine damped by ``exp(-var / 2)``, ``var`` the diagonal's
    variance scaled by ``(2 pi f)^2``. Computed in the reference's float32
    order (2 pi x first, then the frequency, then pi/2): at mip-NeRF's top
    frequency, 2^14 x 2 pi, one float32 ulp of the argument shows in the
    sine."""

    def __init__(self, in_dim: int = 3, num_frequencies: int = 10, min_freq_exp: float = 0.0,
                 max_freq_exp: float = 9.0, include_input: bool = False):
        super().__init__()
        self.in_dim = in_dim
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input

    def get_out_dim(self) -> int:
        return self.in_dim * self.num_frequencies * 2 + (self.in_dim if self.include_input else 0)

    def forward(self, in_tensor: torch.Tensor, covs: Optional[torch.Tensor] = None) -> torch.Tensor:
        freqs = 2.0 ** linspace(self.min_freq_exp, self.max_freq_exp, self.num_frequencies, in_tensor.device)
        scaled = (2.0 * math.pi * in_tensor)[..., None] * freqs  # (..., D, F)
        scaled = scaled.reshape(scaled.shape[:-2] + (-1,))
        if covs is None:
            enc = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
        else:
            var = torch.diagonal(covs, dim1=-2, dim2=-1)[..., :, None] * (freqs * freqs)[None, :]
            var = (2.0 * math.pi) ** 2 * var.reshape(var.shape[:-2] + (-1,))
            enc = expected_sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1), torch.cat([var, var], dim=-1))
        if self.include_input:
            enc = torch.cat([enc, in_tensor], dim=-1)
        return enc


class _TensorEncoding(nn.Module):
    """TensoRF's factorised grids: parameters drawn ``init_scale`` times a
    standard normal, in the reference's names and layouts (``plane_coef``
    (3, C, R, R), ``line_coef`` (3, C, R)), so ``utils.convert`` carries
    them as they are. Inputs are positions in [-1, 1]^3."""

    def __init__(self, resolution: int, num_components: int, init_scale: float, planes: bool, lines: bool,
                 device=None):
        super().__init__()
        self.resolution = resolution
        self.num_components = num_components
        self.init_scale = init_scale
        device = resolve_device(device)
        c, r = num_components, resolution
        if planes:
            self.plane_coef = nn.Parameter(torch.empty((3, c, r, r), device=device))
        if lines:
            self.line_coef = nn.Parameter(torch.empty((3, c, r), device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for p in self.parameters():
                p.normal_(0.0, 1.0, generator=generator).mul_(self.init_scale)


class TensorCPEncoding(_TensorEncoding):
    """CANDECOMP/PARAFAC (reference encodings.py:246-268): the product of
    three lines' samples, (..., C)."""

    def __init__(self, resolution: int = 256, num_components: int = 24, init_scale: float = 0.1, device=None):
        super().__init__(resolution, num_components, init_scale, planes=False, lines=True, device=device)

    def get_out_dim(self) -> int:
        return self.num_components

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        line = self.line_coef
        return (grid_sample_1d(line[0], in_tensor[..., 0]) * grid_sample_1d(line[1], in_tensor[..., 1])
                * grid_sample_1d(line[2], in_tensor[..., 2]))


class TensorVMEncoding(_TensorEncoding):
    """Vector-matrix decomposition (reference encodings.py:271-304): the
    xy, xz and yz planes' samples times the z, y and x lines', concatenated
    (..., 3C)."""

    def __init__(self, resolution: int = 128, num_components: int = 24, init_scale: float = 0.1, device=None):
        super().__init__(resolution, num_components, init_scale, planes=True, lines=True, device=device)

    def get_out_dim(self) -> int:
        return 3 * self.num_components

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        plane, line = self.plane_coef, self.line_coef
        x, y, z = in_tensor[..., 0], in_tensor[..., 1], in_tensor[..., 2]
        return torch.cat([grid_sample_2d(plane[0], in_tensor[..., (0, 1)]) * grid_sample_1d(line[0], z),
                          grid_sample_2d(plane[1], in_tensor[..., (0, 2)]) * grid_sample_1d(line[1], y),
                          grid_sample_2d(plane[2], in_tensor[..., (1, 2)]) * grid_sample_1d(line[2], x)], dim=-1)


class TriplaneEncoding(_TensorEncoding):
    """Three axis-aligned planes (xy, xz, yz), their samples summed or
    multiplied (reference encodings.py:307-333), (..., C)."""

    def __init__(self, resolution: int = 32, num_components: int = 64, init_scale: float = 0.1,
                 reduce: str = "sum", device=None):
        if reduce not in ("sum", "product"):
            raise ValueError(f"reduce {reduce!r}")
        self.reduce = reduce
        super().__init__(resolution, num_components, init_scale, planes=True, lines=False, device=device)

    def get_out_dim(self) -> int:
        return self.num_components

    def forward(self, in_tensor: torch.Tensor) -> torch.Tensor:
        plane = self.plane_coef
        p0 = grid_sample_2d(plane[0], in_tensor[..., (0, 1)])
        p1 = grid_sample_2d(plane[1], in_tensor[..., (0, 2)])
        p2 = grid_sample_2d(plane[2], in_tensor[..., (1, 2)])
        return p0 + p1 + p2 if self.reduce == "sum" else p0 * p1 * p2
