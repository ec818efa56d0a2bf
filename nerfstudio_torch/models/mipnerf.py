"""mip-NeRF (counterpart of ``nerfstudio_tpu/models/mipnerf.py``): vanilla
NeRF's two passes with ONE field, shared by both, that encodes each
sample's conical-frustum Gaussian with the integrated encoding at 16
frequencies; the PDF samples replace the uniform ones (no merge)."""

from __future__ import annotations

import dataclasses

from nerfstudio_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_torch.models.vanilla_nerf import NeRFModel, VanillaModelConfig


@dataclasses.dataclass
class MipNerfModelConfig(VanillaModelConfig):
    """(reference mipnerf.py:27-29)"""

    def __post_init__(self):
        self._target = MipNerfModel


class MipNerfModel(NeRFModel):
    """(reference mipnerf.py:32-99)"""

    include_original = False

    def make_fields(self, device) -> None:
        self.field = NeRFField(position_encoding_num_frequencies=16, direction_encoding_num_frequencies=4,
                               use_integrated_encoding=True, device=device)

    def fields(self):
        return self.field, self.field
