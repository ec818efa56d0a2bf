"""Input encodings (counterpart of
``nerfstudio_tpu/field_components/encodings.py``): ``HashEncoding`` on the
block and flat layouts, ``SHEncoding`` and ``NeRFEncoding``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerfstudio_torch.model_components.ray_samplers import linspace
from nerfstudio_torch.ops.hash_grid import hash_encode, init_hash_table
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.spherical_harmonics import components_from_spherical_harmonics


class HashEncoding(nn.Module):
    """Instant-NGP multiresolution hash grid (reference encodings.py:162-230).

    Every path reads the (L, S, 128) table. With neither flag it is the flat
    layout (K7, exact 8-corner trilerp, differentiable). Otherwise the block
    layout: K1 (stochastic one-block trilerp, differentiable) or K3 (exact
    8-corner trilerp, forward only), picked by the mode on every call: K3
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
    """Multiscale sinusoidal positional encoding (reference encodings.py:57-91):
    ``sin([s, s + pi/2])`` of ``s = 2 pi x * 2^linspace(min, max, n)`` per
    input dimension (dimension-major), the input appended last with
    ``include_input``. The integrated (covariance) branch is not ported."""

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
        if covs is not None:
            raise NotImplementedError("the integrated (covariance) NeRF encoding is not ported")
        freqs = 2.0 ** linspace(self.min_freq_exp, self.max_freq_exp, self.num_frequencies, in_tensor.device)
        scaled = (2.0 * math.pi * in_tensor)[..., None] * freqs  # (..., D, F)
        scaled = scaled.reshape(scaled.shape[:-2] + (-1,))
        enc = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
        if self.include_input:
            enc = torch.cat([enc, in_tensor], dim=-1)
        return enc
