"""Real spherical harmonics (counterpart of
``nerfstudio_tpu/utils/spherical_harmonics.py``), levels 1 to 4."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
C3 = (
    -0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
    -0.4570457994644658, 1.445305721320277, -0.5900435899266435,
)


def components_from_spherical_harmonics(levels: int, directions: torch.Tensor) -> torch.Tensor:
    """SH basis values for directions (..., 3) -> (..., levels**2), same
    polynomials and operation order as the reference (:34-83)."""
    if not 1 <= levels <= 4:
        raise NotImplementedError(f"SH levels {levels}: only levels 1 to 4 are ported")
    x = directions[..., 0]
    y = directions[..., 1]
    z = directions[..., 2]
    comps = [torch.full_like(x, C0)]
    if levels > 1:
        comps += [-C1 * y, C1 * z, -C1 * x]
    if levels > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if levels > 3:
        comps += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(comps, dim=-1)
