"""Real spherical harmonics (counterpart of
``nerfstudio_tpu/utils/spherical_harmonics.py``), levels 1 to 5: the
direction encoding of the fields and the colour of 3DGS."""

from __future__ import annotations

import torch

MAX_SH_DEGREE = 4

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
C3 = (
    -0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
    -0.4570457994644658, 1.445305721320277, -0.5900435899266435,
)
C4 = (
    2.5033429417967046, -1.7701307697799304, 0.9461746957575601, -0.6690465435572892,
    0.10578554691520431, -0.6690465435572892, 0.47308734787878004, -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_bases(degree: int) -> int:
    """Bases for SH of degree <= 4 (reference :27-30)."""
    if degree > MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} > {MAX_SH_DEGREE}")
    return (degree + 1) ** 2


def components_from_spherical_harmonics(levels: int, directions: torch.Tensor) -> torch.Tensor:
    """SH basis values for directions (..., 3) -> (..., levels**2), same
    polynomials and operation order as the reference (:33-79)."""
    if not 1 <= levels <= 5:
        raise ValueError(f"SH levels {levels}: levels run from 1 to 5")
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
    if levels > 4:
        comps += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


def eval_sh(degree: int, coeffs: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """SH colour: coeffs (..., K, C), directions (..., 3) -> (..., C) (reference :82-85)."""
    basis = components_from_spherical_harmonics(degree + 1, directions)
    return torch.sum(basis[..., :, None] * coeffs, dim=-2)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5
