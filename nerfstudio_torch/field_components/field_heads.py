"""Field output names (counterpart of
``nerfstudio_tpu/field_components/field_heads.py``). The head modules
themselves belong to heads the ported fields do not use yet."""

from __future__ import annotations

import enum


class FieldHeadNames(enum.Enum):
    """Possible field outputs (reference field_heads.py:12-26)."""

    RGB = "rgb"
    SH = "sh"
    DENSITY = "density"
    NORMALS = "normals"
    PRED_NORMALS = "pred_normals"
    UNCERTAINTY = "uncertainty"
    TRANSIENT_RGB = "transient_rgb"
    TRANSIENT_DENSITY = "transient_density"
    SEMANTICS = "semantics"
    SDF = "sdf"
    ALPHA = "alpha"
    GRADIENT = "gradient"
