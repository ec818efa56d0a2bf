"""The port's entry points run on the GPU unless the caller names another
device: ``device=None`` resolves to CUDA, and where CUDA is absent it raises
instead of falling back to the CPU. The card is simulated by patching
``torch.cuda.is_available``, so the tests decide nothing at import."""

import numpy as np
import pytest
import torch

from _torch_port import CPU, orbit_c2w
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.data.datamanagers import DataManagerConfig, DeviceCacheDataManager, FullImageDatamanager
from nerfstudio_torch.field_components.encodings import HashEncoding
from nerfstudio_torch.field_components.mlp import MLP
from nerfstudio_torch.fields.density_fields import HashMLPDensityField
from nerfstudio_torch.fields.sdf_field import SDFField
from nerfstudio_torch.models.instant_ngp import InstantNGPModelConfig
from nerfstudio_torch.models.nerfacto import NerfactoModelConfig
from nerfstudio_torch.models.neus import NeuSFactoModelConfig
from nerfstudio_torch.model_components.bilateral_grid import init_bilateral_grid
from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig, init_gaussian_params
from nerfstudio_torch.ops.occupancy import init_occupancy_grid
from nerfstudio_torch.utils.device import resolve_device


def _cameras(device=CPU):
    return Cameras.create(orbit_c2w(2), 8.0, 8.0, 4.0, 4.0, 8, 8, device=device)


ENTRY_POINTS = {
    "nerfacto": lambda **kw: NerfactoModelConfig(num_levels=2, log2_hashmap_size=10, max_res=32).setup(**kw),
    "neus-facto": lambda **kw: NeuSFactoModelConfig(num_layers=2, hidden_dim=8, geo_feat_dim=4,
                                                    num_layers_color=2, hidden_dim_color=8).setup(**kw),
    "sdf field": lambda **kw: SDFField(num_layers=2, hidden_dim=8, geo_feat_dim=4, num_layers_color=2,
                                       hidden_dim_color=8, **kw),
    "proposal field": lambda **kw: HashMLPDensityField(num_levels=2, log2_hashmap_size=10, **kw),
    "hash encoding": lambda **kw: HashEncoding(num_levels=2, log2_hashmap_size=10, **kw),
    "mlp": lambda **kw: MLP(in_dim=4, num_layers=2, layer_width=8, **kw),
    "cameras": lambda **kw: Cameras.create(orbit_c2w(2), 8.0, 8.0, 4.0, 4.0, 8, 8, **kw),
    "device datamanager": lambda **kw: DeviceCacheDataManager(
        DataManagerConfig(), _cameras(), torch.zeros((2, 8, 8, 3), dtype=torch.uint8), **kw),
    "full-image datamanager": lambda **kw: FullImageDatamanager(
        _cameras(), torch.zeros((2, 8, 8, 3), dtype=torch.uint8), **kw),
    "splat init": lambda **kw: init_gaussian_params(SplatfactoModelConfig(max_gaussians=16, num_random=8), **kw),
    "bilateral grids": lambda **kw: init_bilateral_grid(2, **kw),
    "instant-ngp": lambda **kw: InstantNGPModelConfig(num_levels=2, log2_hashmap_size=10, max_res=32).setup(**kw),
    "occupancy grid": lambda **kw: init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), 8, **kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_a_device_raises_without_cuda(name, monkeypatch):
    """No device and no CUDA: a clear error, not a CPU fall-back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_runs_where_it_is_asked(name, monkeypatch):
    """An explicit CPU device needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ENTRY_POINTS[name](device=CPU) is not None


def test_none_resolves_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    cams = _cameras()
    assert cams.camera_to_worlds.device.type == "cpu" and np.isfinite(cams.fx.numpy()).all()
