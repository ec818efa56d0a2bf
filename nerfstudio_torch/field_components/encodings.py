"""Input encodings (counterpart of
``nerfstudio_tpu/field_components/encodings.py``): ``HashEncoding`` on the
block layout and ``SHEncoding``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerfstudio_torch.ops.hash_grid import hash_encode, init_hash_table
from nerfstudio_torch.utils.spherical_harmonics import components_from_spherical_harmonics


class HashEncoding(nn.Module):
    """Instant-NGP multiresolution hash grid (reference encodings.py:162-230).

    Both paths read the (L, S, 128) table: K1 (stochastic one-block trilerp,
    differentiable) and K3 (exact 8-corner trilerp, forward only). The mode
    picks one on every call: K3 only when ``block_exact`` is set and the
    module is in eval mode, K1 otherwise, as the reference field's
    ``block_exact=hash_block and not train and exact_eval``."""

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
        if not (block or block_exact):
            raise NotImplementedError("only the block-packed hash-grid layout is ported")
        self.num_levels = num_levels
        self.min_res = min_res
        self.max_res = max_res
        self.log2_hashmap_size = log2_hashmap_size
        self.features_per_level = features_per_level
        self.hash_init_scale = hash_init_scale
        self.block = block
        self.block_exact = block_exact
        self.hash_table = nn.Parameter(
            init_hash_table(num_levels, self.hash_table_size, features_per_level, hash_init_scale, device=device)
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
        exact = self.block_exact and not self.training
        return hash_encode(
            in_tensor.contiguous(),
            self.hash_table,
            num_levels=self.num_levels,
            min_res=self.min_res,
            max_res=self.max_res,
            hash_table_size=self.hash_table_size,
            block=not exact,
            block_exact=exact,
            bwd_levels=None if exact else bwd_levels,
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
