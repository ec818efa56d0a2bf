"""SDF field of the NeuS models (counterpart of
``nerfstudio_tpu/fields/sdf_field.py``).

The geometric network maps ``[xyz, PE(xyz)]`` (raw xyz first, 6 PE
frequencies) through weight-normalised layers with the reference's skip at
layer 4 (kept only where the receiving width exceeds the input width) and
a beta=100 softplus to (sdf, geo features); the colour network maps
``[xyz, PE(dir), normal, geo features]`` through plain layers to a sigmoid.
The SDF gradient is taken by autograd (also in eval, where the caller's
no-grad is lifted locally); in training its graph is kept
(``create_graph``) so the eikonal loss and the normals reach the weights.
With ``use_numerical_gradients`` the SDF gradient is instead the central
difference over six more geometric passes at +-``NUMERICAL_GRADIENT_DELTA``
per axis, differentiable in the weights. The colour network also takes a
per-image appearance embedding when asked: the camera's own in training,
their mean at eval under ``use_average_appearance_embedding``, else
zeros. NeuS alphas follow the reference's cos annealing. Everything runs
in float32."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from nerfstudio_torch.core.rays import RaySamples
from nerfstudio_torch.field_components.embedding import Embedding
from nerfstudio_torch.field_components.encodings import NeRFEncoding
from nerfstudio_torch.field_components.field_heads import FieldHeadNames
from nerfstudio_torch.utils.device import resolve_device
from nerfstudio_torch.utils.math import clip


class _Softplus(torch.autograd.Function):
    """``logaddexp(x, 0)`` with JAX's derivative ``exp(x - out)`` (= sigmoid
    x, never above 1). torch's own logaddexp backward, ``1 / (1 + exp(-x))``,
    overflows in its second derivative for x below about -88 and gives NaN
    in the eikonal term's double backward."""

    @staticmethod
    def forward(ctx, x):
        out = torch.logaddexp(x, x.new_zeros(()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * torch.exp(x - out)


def softplus100(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(100 h) / 100``: the exact ``logaddexp(100 h, 0)``.
    torch's ``softplus(beta=100)`` turns linear past its threshold of 20 and
    so differs from the reference wherever 100 h > 20."""
    return _Softplus.apply(100.0 * h) / 100.0


class LearnedVariance(nn.Module):
    """``exp(10 * variance)``, one learned scalar (reference sdf_field.py:32-40)."""

    def __init__(self, init_val: float = 0.1, device=None):
        super().__init__()
        self.init_val = init_val
        self.variance = nn.Parameter(torch.tensor(init_val, dtype=torch.float32, device=resolve_device(device)))

    def forward(self) -> torch.Tensor:
        return torch.exp(self.variance * 10.0)


class WNDense(nn.Module):
    """Weight-normalised dense layer (reference sdf_field.py:43-61):
    ``y = x W_eff^T + b`` with ``W_eff = scale * W / max(||W||_row, 1e-12)``
    (rows of ``weight`` are the reference kernel's columns). The clamp is
    the reference's; ``torch.nn.utils.weight_norm`` has none."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty((out_features, in_features), device=device))
        self.scale = nn.Parameter(torch.empty((out_features,), device=device))
        self.bias = nn.Parameter(torch.zeros((out_features,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.clamp_min(torch.linalg.norm(self.weight, dim=1), 1e-12)
        return Fn.linear(x, self.weight * (self.scale / norm)[:, None], self.bias)


# The geometric layer that takes [xyz, PE(xyz)] again (reference :128).
SKIP_IN = (4,)
# The numerical gradient's step on each axis (reference :126).
NUMERICAL_GRADIENT_DELTA = 1e-4


class SDFField(nn.Module):
    """(reference sdf_field.py:111-460), the fields and defaults of the JAX
    ``SDFField`` that the NeuS configs set; the geometric init is always on
    and the skip always at layer 4, as every config of the reference leaves
    them."""

    def __init__(
        self,
        num_layers: int = 8,
        hidden_dim: int = 256,
        geo_feat_dim: int = 256,
        num_layers_color: int = 4,
        hidden_dim_color: int = 256,
        bias: float = 0.8,
        inside_outside: bool = False,
        weight_norm: bool = True,
        appearance_embedding_dim: int = 32,
        num_images: int = 1,
        use_appearance_embedding: bool = False,
        use_average_appearance_embedding: bool = False,
        use_numerical_gradients: bool = False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.bias_init = bias
        self.inside_outside = inside_outside
        self.appearance_embedding_dim = appearance_embedding_dim if use_appearance_embedding else 0
        self.use_average_appearance_embedding = use_average_appearance_embedding
        self.use_numerical_gradients = use_numerical_gradients
        if use_appearance_embedding:
            self.embedding_appearance = Embedding(num_images, appearance_embedding_dim, device=device)
        self.position_encoding = NeRFEncoding(3, num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0)
        self.direction_encoding = NeRFEncoding(3, num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0,
                                               include_input=True)
        self.deviation_network = LearnedVariance(device=device)

        self.in_dim = 3 + self.position_encoding.get_out_dim()
        dims = [self.in_dim] + [hidden_dim] * (num_layers - 1) + [1 + geo_feat_dim]
        # a skip is representable only where the receiving width exceeds the input's
        self.skips = tuple(s for s in SKIP_IN if 0 < s < len(dims) - 1 and dims[s] - self.in_dim > 0)
        layers = []
        for i in range(len(dims) - 1):
            out_dim = dims[i + 1] - self.in_dim if (i + 1) in self.skips else dims[i + 1]
            layers.append(WNDense(dims[i], out_dim, device) if weight_norm else nn.Linear(dims[i], out_dim,
                                                                                         device=device))
        self.glin = nn.ModuleList(layers)
        color_in = 3 + self.direction_encoding.get_out_dim() + 3 + geo_feat_dim + self.appearance_embedding_dim
        cdims = [color_in] + [hidden_dim_color] * (num_layers_color - 1) + [3]
        self.clin = nn.ModuleList(nn.Linear(a, b, device=device) for a, b in zip(cdims[:-1], cdims[1:]))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's init (sdf_field.py:64-97): the SAL geometric init of
        the geometric layers (first layer live on the raw xyz only, the skip
        layer dead on the re-fed PE, the last layer a sphere of radius
        ``bias``), weight-norm scales at the initial row norms, and flax's
        LeCun truncated normal for the colour layers, and flax's Embed init
        for the appearance embedding."""

        device = self.deviation_network.variance.device

        def normal(shape, std, mean=0.0):
            return torch.randn(shape, generator=generator, device=device) * std + mean

        def lecun(layer):
            std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)

        with torch.no_grad():
            n = len(self.glin)
            for i, layer in enumerate(self.glin):
                fan_out, fan_in = layer.weight.shape
                layer.bias.zero_()
                if i == n - 1:
                    sign = -1.0 if self.inside_outside else 1.0
                    layer.weight.copy_(normal((fan_out, fan_in), 1e-4, sign * math.sqrt(math.pi) / math.sqrt(fan_in)))
                    layer.bias.fill_(self.bias_init if self.inside_outside else -self.bias_init)
                elif i == 0:
                    layer.weight.zero_()
                    layer.weight[:, :3] = normal((fan_out, 3), math.sqrt(2.0 / fan_out))
                else:
                    layer.weight.copy_(normal((fan_out, fan_in), math.sqrt(2.0 / fan_out)))
                    if i in self.skips:  # the re-fed [xyz, pe] tail: PE columns dead
                        layer.weight[:, fan_in - (self.in_dim - 3):] = 0.0
                if isinstance(layer, WNDense):
                    layer.scale.copy_(torch.linalg.norm(layer.weight, dim=1))
            for layer in self.clin:
                lecun(layer)
                layer.bias.zero_()
        if self.appearance_embedding_dim:
            self.embedding_appearance.reset_parameters(generator)

    def forward_geonetwork(self, positions: torch.Tensor) -> torch.Tensor:
        """positions (..., 3) -> [sdf, geo features] (..., 1 + geo_feat_dim)."""
        inputs = torch.cat([positions, self.position_encoding(positions)], dim=-1)
        h = inputs
        for i, layer in enumerate(self.glin):
            if i in self.skips:
                h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
            h = layer(h)
            if i < len(self.glin) - 1:
                h = softplus100(h)
        return h

    def get_sdf(self, ray_samples: RaySamples) -> torch.Tensor:
        return self.forward_geonetwork(ray_samples.frustums.get_positions())[..., :1]

    def get_alpha(self, ray_samples: RaySamples, sdf: torch.Tensor, gradients: torch.Tensor,
                  cos_anneal_ratio: float = 1.0) -> torch.Tensor:
        """NeuS alpha from the SDF's section estimates (reference :170-190)."""
        inv_s = self.deviation_network()
        true_cos = torch.sum(ray_samples.frustums.directions * gradients, dim=-1, keepdim=True)
        iter_cos = -(
            torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio) + torch.relu(-true_cos) * cos_anneal_ratio
        )
        deltas = ray_samples.deltas
        est_next = sdf + iter_cos * deltas * 0.5
        est_prev = sdf - iter_cos * deltas * 0.5
        next_cdf = torch.sigmoid(est_next * inv_s)
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        return clip((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)

    def numerical_gradient(self, positions: torch.Tensor) -> torch.Tensor:
        """Central differences of the SDF at +-delta on each axis (reference
        :207-227): six geometric passes, differentiable in the weights."""
        d = NUMERICAL_GRADIENT_DELTA
        offsets = torch.tensor([[d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0], [0, 0, d], [0, 0, -d]],
                               dtype=positions.dtype, device=positions.device)
        pts = positions[..., None, :] + offsets  # (..., 6, 3)
        sdf = self.forward_geonetwork(pts.reshape(-1, 3))[..., 0].reshape(positions.shape[:-1] + (6,))
        return torch.stack([(sdf[..., 2 * a] - sdf[..., 2 * a + 1]) / (2 * d) for a in range(3)], dim=-1)

    def get_colors(self, points, directions, normals, geo_features,
                   camera_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(reference :258-285) the colour network; with the appearance
        embedding, the camera's code in training, else the mean code (under
        ``use_average_appearance_embedding``) or zeros."""
        inputs = [points, self.direction_encoding(directions), normals, geo_features]
        if self.appearance_embedding_dim:
            if camera_indices is not None and self.training:
                emb = self.embedding_appearance(camera_indices[..., 0])
            else:
                shape = points.shape[:-1] + (self.appearance_embedding_dim,)
                emb = (self.embedding_appearance.mean().expand(shape) if self.use_average_appearance_embedding
                       else points.new_zeros(shape))
            inputs.append(emb)
        h = torch.cat(inputs, dim=-1)
        for i, layer in enumerate(self.clin):
            h = layer(h)
            if i < len(self.clin) - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)

    def forward(self, ray_samples: RaySamples, cos_anneal_ratio: float = 1.0) -> Dict[FieldHeadNames, torch.Tensor]:
        """(reference :222-244) rgb, sdf, alpha, normals and the SDF gradient.
        The geometric network runs once; its output is differentiated with
        respect to the positions (or differenced, with numerical
        gradients), with the graph kept when the caller records one
        (training: the eikonal loss and the normals backprop through the
        gradient)."""
        positions = ray_samples.frustums.get_positions()
        keep_graph = torch.is_grad_enabled()
        if self.use_numerical_gradients:
            h = self.forward_geonetwork(positions)
            gradients = self.numerical_gradient(positions)
        else:
            with torch.enable_grad():
                p = positions.detach().requires_grad_(True)
                h = self.forward_geonetwork(p)
                (gradients,) = torch.autograd.grad(h[..., 0].sum(), p, create_graph=keep_graph)
            if not keep_graph:
                h = h.detach()
        sdf, geo = h[..., :1], h[..., 1:]
        normals = gradients / torch.clamp_min(torch.linalg.norm(gradients, dim=-1, keepdim=True), 1e-10)
        alpha = self.get_alpha(ray_samples, sdf, gradients, cos_anneal_ratio)
        rgb = self.get_colors(positions, ray_samples.frustums.directions, normals, geo, ray_samples.camera_indices)
        return {
            FieldHeadNames.RGB: rgb,
            FieldHeadNames.SDF: sdf,
            FieldHeadNames.ALPHA: alpha,
            FieldHeadNames.NORMALS: normals,
            FieldHeadNames.GRADIENT: gradients,
        }
