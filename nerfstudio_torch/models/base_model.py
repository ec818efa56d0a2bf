"""Model base and chunked full-image rendering (counterpart of
``nerfstudio_tpu/models/base_model.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Type

import torch
from torch import nn

from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.core.rays import RayBundle


@dataclasses.dataclass
class ModelConfig:
    """(reference base_model.py:28-44)"""

    _target: Type = dataclasses.field(default=None)  # type: ignore[assignment]
    enable_collider: bool = True
    collider_params: Optional[Dict[str, float]] = dataclasses.field(
        default_factory=lambda: {"near_plane": 2.0, "far_plane": 6.0}
    )
    loss_coefficients: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"rgb_loss_coarse": 1.0, "rgb_loss_fine": 1.0}
    )
    eval_num_rays_per_chunk: int = 4096
    prompt: Optional[str] = None

    def setup(self, **kwargs):
        return self._target(self, **kwargs)


class Model(nn.Module):
    """Base model: ``forward(ray_bundle, **kw) -> outputs dict``."""

    def __init__(
        self,
        config: Any,
        scene_aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
            (-1.0, -1.0, -1.0),
            (1.0, 1.0, 1.0),
        ),
        num_train_data: int = 1,
    ):
        super().__init__()
        self.config = config
        self.scene_aabb = scene_aabb
        self.num_train_data = num_train_data

    def forward(self, ray_bundle: RayBundle, **kwargs) -> Dict[str, Any]:
        return self.get_outputs(ray_bundle, **kwargs)

    def get_outputs(self, ray_bundle: RayBundle, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


@torch.no_grad()
def render_camera(
    model: Model,
    params: Optional[Mapping[str, torch.Tensor]],
    cameras: Cameras,
    camera_idx: int,
    chunk_size: int = 4096,
    aux=None,
    camera_opt_to_camera: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Chunked full-image inference (reference base_model.py:92-141 and the
    pipeline's render_camera, base_pipeline.py:318).

    ``params`` (a state dict, or None for the model's own) is applied with
    ``torch.func.functional_call``; ``aux`` is the model's auxiliary state
    (nerfacto's occupancy grid; None for a model without one, which then
    gets no ``model_aux``). The flattened rays are padded to a chunk
    multiple with copies of the last ray, each chunk is rendered, and the
    outputs come back as (H, W, C) tensors on the model's device. A model
    that needs gradients at eval (the SDF field's normals, nerfacto's
    density-gradient normals) enables them itself inside this no-grad
    render. ``camera_opt_to_camera`` (3, 4) corrects the camera's pose
    (reference base_model.py:97)."""
    if model.training:
        raise ValueError("render_camera renders the eval forward: call model.eval() first")
    device = next(model.parameters()).device
    rb = cameras.generate_rays(camera_indices=camera_idx, camera_opt_to_camera=camera_opt_to_camera)
    h, w = rb.shape
    flat = rb.flatten().map(lambda x: x.to(device))
    n = h * w
    n_pad = (-n) % chunk_size
    if n_pad:
        flat = flat.map(lambda x: torch.cat([x, x[-1:].expand((n_pad,) + x.shape[1:])], dim=0))

    kwargs = {} if aux is None else {"model_aux": aux}
    chunk_outs = []
    for start in range(0, n + n_pad, chunk_size):
        rb_i = flat.map(lambda x: x[start : start + chunk_size])
        if params is None:
            out = model(rb_i, **kwargs)
        else:
            out = torch.func.functional_call(model, params, (rb_i,), kwargs)
        chunk_outs.append({k: v for k, v in out.items() if isinstance(v, torch.Tensor)})
    images = {}
    for k in chunk_outs[0]:
        arr = torch.cat([c[k] for c in chunk_outs], dim=0)[:n]
        images[k] = arr.reshape((h, w) + tuple(arr.shape[1:]))
    return images
