"""3DGS projection, 3D gaussians to screen-space 2D gaussians (counterpart of
``nerfstudio_tpu/ops/gsplat/projection.py``).

Conventions as the reference: OpenCV camera (x right, y down, z forward),
w2c viewmat, intrinsics (fx, fy, cx, cy), quats wxyz (normalised inside).

``project_gaussians`` is K4: a ``torch.autograd.Function`` over the
hand-written forward and backward kernels of ``csrc/gsplat.cu`` on CUDA
tensors, over the plain PyTorch twin ``_project_twin`` (whose backward is
autograd through it) on CPU tensors. The backward returns the viewmat's
gradient too when autograd asks for it (camera optimisation); the kernel
then sums it over the gaussians deterministically and counts the launch
once more under ``project_gaussians_bwd_viewmat``."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nerfstudio_torch.ops.gsplat import _cuda


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz -> (N, 3, 3) (reference :18-29)."""
    q = quats / torch.clamp_min(torch.linalg.vector_norm(quats, dim=-1, keepdim=True), 1e-8)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(N, 3) linear scales, (N, 4) quats -> (N, 3, 3) R S^2 R^T (reference :32-36)."""
    M = quat_to_rotmat(quats) * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def get_viewmat(c2w_opengl: torch.Tensor) -> torch.Tensor:
    """OpenGL c2w (3, 4) -> OpenCV w2c (4, 4) (reference :157-169)."""
    R = c2w_opengl[:3, :3]
    T = c2w_opengl[:3, 3]
    R_inv = (R * torch.tensor([1.0, -1.0, -1.0], dtype=R.dtype, device=R.device)).T
    viewmat = torch.eye(4, dtype=c2w_opengl.dtype, device=c2w_opengl.device)
    viewmat[:3, :3] = R_inv
    viewmat[:3, 3] = -(R_inv @ T)
    return viewmat


def intrinsics(fx: float, fy: float, cx: float, cy: float, width: int, height: int, near: float,
               eps2d: float) -> np.ndarray:
    """The 8 float32 camera values after the viewmat's 12 that the kernels
    read: the intrinsics, the EWA clip limits 1.3 * W / (2 fx) computed in
    float32 as the reference computes them, the near plane and the dilation."""
    f32 = np.float32
    lim_x = f32(1.3) * (f32(width) / (f32(2.0) * f32(fx)))
    lim_y = f32(1.3) * (f32(height) / (f32(2.0) * f32(fy)))
    return np.array([fx, fy, cx, cy, lim_x, lim_y, near, eps2d], np.float32)


def camera_params(viewmat: torch.Tensor, fx: float, fy: float, cx: float, cy: float, width: int, height: int,
                  near: float, eps2d: float) -> np.ndarray:
    """The 20 float32 camera values of a host launch: viewmat rows 0-2
    (read on the host) and ``intrinsics``."""
    rows = viewmat.detach().to("cpu", torch.float32).numpy()[:3].reshape(-1)
    return np.concatenate([rows, intrinsics(fx, fy, cx, cy, width, height, near, eps2d)]).astype(np.float32)


def _project_twin(means, scales, quats, viewmat, fx, fy, cx, cy, width, height, near=0.01, eps2d=0.3,
                  antialiased=False):
    """Plain PyTorch K4 forward, operation for operation as the reference
    (:64-154): (means2d, depths, conics, radii, valid, compensations). The
    viewmat (4, 4), or one per gaussian (N, 4, 4), enters as a tensor in
    the means' dtype, so autograd carries a gradient into it."""
    cam = torch.from_numpy(intrinsics(fx, fy, cx, cy, width, height, near, eps2d)).to(means.device)
    view = viewmat.to(device=means.device, dtype=means.dtype)[..., :3, :]
    R = lambda r, k: view[..., r, k]  # noqa: E731
    t = lambda r: view[..., r, 3]  # noqa: E731
    fx, fy, cx, cy, lim_x, lim_y = (cam[k] for k in range(6))
    mx, my, mz = means.unbind(-1)
    px = R(0, 0) * mx + R(0, 1) * my + R(0, 2) * mz + t(0)
    py = R(1, 0) * mx + R(1, 1) * my + R(1, 2) * mz + t(1)
    z = R(2, 0) * mx + R(2, 1) * my + R(2, 2) * mz + t(2)
    inv_z = 1.0 / torch.maximum(z, z.new_tensor(1e-6))
    xs = px * inv_z
    ys = py * inv_z
    means2d = torch.stack([xs * fx + cx, ys * fy + cy], dim=-1)

    norm = torch.sqrt(quats[:, 0] * quats[:, 0] + quats[:, 1] * quats[:, 1]
                      + quats[:, 2] * quats[:, 2] + quats[:, 3] * quats[:, 3])
    q = quats / torch.maximum(norm, norm.new_tensor(1e-8))[:, None]
    qw, qx, qy, qz = q.unbind(-1)
    g = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    s = [scales[:, k] * scales[:, k] for k in range(3)]
    c = {(i, j): g[i][0] * g[j][0] * s[0] + g[i][1] * g[j][1] * s[1] + g[i][2] * g[j][2] * s[2]
         for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}
    c00, c01, c02, c11, c12, c22 = (c[k] for k in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))
    a = [
        (R(r, 0) * c00 + R(r, 1) * c01 + R(r, 2) * c02,
         R(r, 0) * c01 + R(r, 1) * c11 + R(r, 2) * c12,
         R(r, 0) * c02 + R(r, 1) * c12 + R(r, 2) * c22)
        for r in range(3)
    ]
    v = {(i, j): a[i][0] * R(j, 0) + a[i][1] * R(j, 1) + a[i][2] * R(j, 2)
         for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}
    txz = torch.minimum(torch.maximum(xs, -lim_x), lim_x)
    tyz = torch.minimum(torch.maximum(ys, -lim_y), lim_y)
    jx = fx * inv_z
    jy = fy * inv_z
    kx = -fx * txz * inv_z
    ky = -fy * tyz * inv_z
    cov00 = jx * (jx * v[0, 0] + kx * v[0, 2]) + kx * (jx * v[0, 2] + kx * v[2, 2])
    cov01 = jy * (jx * v[0, 1] + kx * v[1, 2]) + ky * (jx * v[0, 2] + kx * v[2, 2])
    cov11 = jy * (jy * v[1, 1] + ky * v[1, 2]) + ky * (jy * v[1, 2] + ky * v[2, 2])
    det_orig = cov00 * cov11 - cov01 * cov01
    cov00 = cov00 + cam[7]
    cov11 = cov11 + cam[7]
    det = cov00 * cov11 - cov01 * cov01
    det_safe = torch.maximum(det, det.new_tensor(1e-10))
    inv_det = 1.0 / det_safe
    conics = torch.stack([cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det], dim=-1)
    if antialiased:
        comp = torch.sqrt(torch.clamp_min(det_orig / det_safe, 0.0))
    else:
        comp = torch.ones_like(det)

    with torch.no_grad():
        b = 0.5 * (cov00 + cov11)
        v1 = b + torch.sqrt(torch.clamp_min(b * b - det_safe, 0.01))
        radii = torch.ceil(3.0 * torch.sqrt(v1))
        m2x, m2y = means2d[:, 0], means2d[:, 1]
        inside = (m2x + radii > 0) & (m2x - radii < width) & (m2y + radii > 0) & (m2y - radii < height)
        valid = (z > cam[6]) & inside & (det > 0)
        radii = torch.where(valid, radii, torch.zeros_like(radii))
    return means2d, z, conics, radii, valid, comp


def _project_twin_bwd(means, scales, quats, cam_args, d_means2d, d_depths, d_conics, d_comp, need_viewmat=False):
    """Plain PyTorch K4 backward, autograd through the twin: (d_means,
    d_scales, d_quats, d_viewmat or None). ``cam_args[0]``, the viewmat, may
    be one per gaussian (N, 4, 4): its gradient then keeps every gaussian's
    contribution apart."""
    viewmat, *rest = cam_args
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (means, scales, quats)]
        if need_viewmat:
            leaves.append(viewmat.detach().to(means.dtype).requires_grad_(True))
        m2, z, con, _, _, comp = _project_twin(*leaves[:3], leaves[3] if need_viewmat else viewmat, *rest)
        outs, cots = [m2, z, con], [d_means2d, d_depths, d_conics]
        if comp.requires_grad:
            outs.append(comp)
            cots.append(d_comp)
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    return (*grads[:3], grads[3] if need_viewmat else None)


def _launch_camera(viewmat: torch.Tensor, means: torch.Tensor, cam_args):
    """(the 20 host floats, the device viewmat rows or None) of a launch: a
    viewmat on the card is read there (rows 0-2 as 12 contiguous floats),
    one on the host is copied into the host array."""
    _, fx, fy, cx, cy, width, height, near, eps2d, _ = cam_args
    if viewmat.device.type == "cuda":
        rows = viewmat.detach()[:3].to(torch.float32).contiguous()
        _cuda.check_cuda("project_gaussians viewmat", means, rows)
        cam = np.concatenate([np.zeros(12, np.float32), intrinsics(fx, fy, cx, cy, width, height, near, eps2d)])
        return cam, rows
    return camera_params(viewmat, fx, fy, cx, cy, width, height, near, eps2d), None


def _project_kernel(means, scales, quats, cam_args):
    """Launch K4 forward: (means2d, depths, conics, radii, valid, compensations)."""
    viewmat, _, _, _, _, width, height, _, _, antialiased = cam_args
    _cuda.check_cuda("project_gaussians", means, scales, quats)
    n = means.shape[0]
    means2d = means.new_empty((n, 2))
    depths = means.new_empty((n,))
    conics = means.new_empty((n, 3))
    radii = means.new_empty((n,))
    valid = torch.empty((n,), dtype=torch.bool, device=means.device)
    comp = means.new_empty((n,))
    cam, rows = _launch_camera(viewmat, means, cam_args)
    _cuda.launch(
        "project_gaussians", "nst_gsplat_project_fwd", means.device,
        means.data_ptr(), scales.data_ptr(), quats.data_ptr(),
        cam.ctypes.data_as(_cuda.ctypes.POINTER(_cuda.ctypes.c_float)), None if rows is None else rows.data_ptr(),
        int(width), int(height), int(antialiased), n, means2d.data_ptr(), depths.data_ptr(), conics.data_ptr(),
        radii.data_ptr(), valid.data_ptr(), comp.data_ptr(),
    )
    return means2d, depths, conics, radii, valid, comp


def _project_bwd_kernel(means, scales, quats, cam_args, d_means2d, d_depths, d_conics, d_comp, need_viewmat=False):
    """Launch K4 backward: (d_means, d_scales, d_quats, d_viewmat or None).
    With ``need_viewmat`` the kernel also sums d(viewmat) over the gaussians
    (per-block partials, then one block), which needs the viewmat on the
    card; d_viewmat is (4, 4) on the viewmat's device, its last row zero."""
    viewmat, _, _, _, _, width, height, _, _, antialiased = cam_args
    cots = [x.contiguous() for x in (d_means2d, d_depths, d_conics, d_comp)]
    _cuda.check_cuda("project_gaussians backward", means, scales, quats, *cots)
    d_means, d_scales, d_quats = torch.empty_like(means), torch.empty_like(scales), torch.empty_like(quats)
    dev_view = viewmat.to(means.device) if need_viewmat else viewmat
    cam, rows = _launch_camera(dev_view, means, cam_args)
    partials = d_view = None
    if need_viewmat:
        partials = means.new_empty((_cuda.kernel_library().nst_gsplat_view_partials(means.shape[0]),))
        d_view = means.new_empty((12,))
    _cuda.launch(
        "project_gaussians_bwd", "nst_gsplat_project_bwd", means.device,
        means.data_ptr(), scales.data_ptr(), quats.data_ptr(),
        cam.ctypes.data_as(_cuda.ctypes.POINTER(_cuda.ctypes.c_float)), None if rows is None else rows.data_ptr(),
        int(width), int(height), int(antialiased), means.shape[0], *(c.data_ptr() for c in cots), d_means.data_ptr(),
        d_scales.data_ptr(), d_quats.data_ptr(), None if partials is None else partials.data_ptr(),
        None if d_view is None else d_view.data_ptr(),
    )
    if not need_viewmat:
        return d_means, d_scales, d_quats, None
    _cuda.launch_counts["project_gaussians_bwd_viewmat"] += 1
    d_viewmat = torch.cat([d_view.view(3, 4), d_view.new_zeros((1, 4))]).to(viewmat.device, viewmat.dtype)
    return d_means, d_scales, d_quats, d_viewmat


class _ProjectGaussians(torch.autograd.Function):
    """K4 forward and backward; the twins on CPU tensors. The backward
    computes d(viewmat) only when autograd asks for it; it is once
    differentiable (the kernel's gradients carry no graph)."""

    @staticmethod
    def forward(ctx, means, scales, quats, viewmat, cam_args):
        ctx.save_for_backward(means, scales, quats, viewmat)
        ctx.cam_args = cam_args
        cam_args = (viewmat, *cam_args)
        if means.device.type == "cuda":
            out = _project_kernel(means, scales, quats, cam_args)
        else:
            out = _project_twin(means, scales, quats, *cam_args)
        ctx.mark_non_differentiable(out[3], out[4])
        if not cam_args[-1]:
            ctx.mark_non_differentiable(out[5])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_means2d, d_depths, d_conics, _d_radii, _d_valid, d_comp):
        means, scales, quats, viewmat = ctx.saved_tensors
        n = means.shape[0]
        zeros = lambda *shape: torch.zeros((n,) + shape, device=means.device)  # noqa: E731
        cots = (zeros(2) if d_means2d is None else d_means2d, zeros() if d_depths is None else d_depths,
                zeros(3) if d_conics is None else d_conics, zeros() if d_comp is None else d_comp)
        cam_args = (viewmat, *ctx.cam_args)
        need_viewmat = ctx.needs_input_grad[3]
        if means.device.type == "cuda":
            grads = _project_bwd_kernel(means, scales, quats, cam_args, *cots, need_viewmat=need_viewmat)
        else:
            grads = _project_twin_bwd(means, scales, quats, cam_args, *cots, need_viewmat=need_viewmat)
        return (*grads, None)


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    near: float = 0.01,
    eps2d: float = 0.3,
    antialiased: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """EWA splatting projection (reference :39-154).

    means, scales (linear) (N, 3) and quats (N, 4) float32; viewmat (4, 4)
    w2c, read on the host where it lies on the CPU and from device memory
    where it lies on the card (no copy to the host: the camera-opt step's
    viewmat, whose gradient the backward then returns). Returns (means2d (N, 2),
    depths (N,), conics (N, 3) packed (a, b, c) of [[a, b], [b, c]], radii
    (N,) float, valid (N,) bool, compensations (N,)): radii and valid carry
    no gradient; compensations are gsplat's antialiasing factor
    sqrt(det / det_dilated) when ``antialiased``, else ones."""
    for name, x, k in (("means", means, 3), ("scales", scales, 3), ("quats", quats, 4)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != k or x.shape[0] != means.shape[0]:
            raise ValueError(f"{name} must be float32 (N, {k}), got {x.dtype} {tuple(x.shape)}")
    if means.device.type not in ("cuda", "cpu"):
        raise ValueError(f"project_gaussians runs on cuda or cpu tensors, got {means.device}")
    if viewmat.shape != (4, 4):
        raise ValueError(f"viewmat must be (4, 4), got {tuple(viewmat.shape)}")
    cam_args = (float(fx), float(fy), float(cx), float(cy), int(width), int(height), float(near), float(eps2d),
                bool(antialiased))
    return _ProjectGaussians.apply(means.contiguous(), scales.contiguous(), quats.contiguous(), viewmat, cam_args)
