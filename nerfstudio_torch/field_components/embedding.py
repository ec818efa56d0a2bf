"""Per-index latent embeddings (counterpart of
``nerfstudio_tpu/field_components/embedding.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerfstudio_torch.utils.device import resolve_device


class Embedding(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.in_dim = in_dim  # number of embeddings
        self.out_dim = out_dim  # embedding size
        self.embedding = nn.Embedding(in_dim, out_dim, device=resolve_device(device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's Embed init: normal with variance 1/out_dim."""
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, 1.0 / math.sqrt(self.out_dim), generator=generator)

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding(indices.long())

    def mean(self) -> torch.Tensor:
        """Average embedding (the eval-time appearance code)."""
        return self.embedding.weight.mean(dim=0)
