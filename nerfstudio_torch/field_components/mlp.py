"""MLP field components (counterpart of
``nerfstudio_tpu/field_components/mlp.py``).

Parameters are float32 master weights; products run in bfloat16 and the
output is cast to float32, as the reference does (mlp.py:60-94). The casts
are differentiable, so autograd carries the gradient back to the float32
weights. Products are
``torch.nn.functional.linear`` (the reference leaves them to XLA too); the
bias is added after the bf16 product, as flax's Dense does."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.utils.device import resolve_device

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
    None: lambda x: x,
}


class MLP(nn.Module):
    """Multi-layer perceptron (reference mlp.py:40-94). At each hidden
    layer ``i`` of ``skip_connections`` the layer reads ``cat([h, x0])``,
    ``x0`` the input in the compute dtype (bfloat16); the output layer
    takes none. ``dtype`` float32 runs every product in float32 (the step
    tests hold the bias gradients so)."""

    def __init__(
        self,
        in_dim: int,
        num_layers: int,
        layer_width: int,
        out_dim: Optional[int] = None,
        skip_connections: Optional[Tuple[int, ...]] = None,
        activation: str = "relu",
        out_activation: Optional[str] = None,
        device=None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.skips = frozenset(skip_connections or ())
        if 0 in self.skips:
            raise ValueError("a skip connection at layer 0 is nonsensical")
        self.dtype = dtype
        self.in_dim = in_dim
        self.num_layers = num_layers
        self.layer_width = layer_width
        self.out_dim = out_dim
        self.act = _ACTIVATIONS[activation]
        self.out_act = _ACTIVATIONS[out_activation]
        widths = [in_dim] + [layer_width] * (num_layers - 1) + [self.get_out_dim()]
        ins = [w + (in_dim if i in self.skips and i < num_layers - 1 else 0) for i, w in enumerate(widths[:-1])]
        device = resolve_device(device)
        self.layers = nn.ModuleList(nn.Linear(a, b, device=device) for a, b in zip(ins, widths[1:]))
        self.reset_parameters()

    def get_out_dim(self) -> int:
        return self.out_dim if self.out_dim is not None else self.layer_width

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's Dense init: LeCun truncated normal kernels, zero biases."""
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        h = x0 = x.to(self.dtype)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if i in self.skips and i < last:
                h = torch.cat([h, x0], dim=-1)
            h = Fn.linear(h, layer.weight.to(self.dtype)) + layer.bias.to(self.dtype)
            if i < last:
                h = self.act(h)
        h = h.to(torch.float32 if in_dtype == torch.float32 else in_dtype)
        return self.out_act(h)


class MLPWithHashEncoding(nn.Module):
    """Hash encoding followed by an MLP (reference mlp.py:97-211), without
    the fused first layer."""

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 1024,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        hash_init_scale: float = 0.001,
        num_layers: int = 2,
        layer_width: int = 64,
        out_dim: Optional[int] = None,
        activation: str = "relu",
        out_activation: Optional[str] = None,
        block: bool = False,
        block_exact: bool = False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.encoding = HashEncoding(
            num_levels=num_levels,
            min_res=min_res,
            max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level,
            hash_init_scale=hash_init_scale,
            block=block,
            block_exact=block_exact,
            device=device,
        )
        self.mlp = MLP(
            in_dim=self.encoding.get_out_dim(),
            num_layers=num_layers,
            layer_width=layer_width,
            out_dim=out_dim,
            activation=activation,
            out_activation=out_activation,
            device=device,
        )

    def get_out_dim(self) -> int:
        return self.mlp.get_out_dim()

    def forward(self, x: torch.Tensor, bwd_levels=None, bwd_scale: float = 1.0) -> torch.Tensor:
        return self.mlp(self.encoding(x, bwd_levels=bwd_levels, bwd_scale=bwd_scale))
