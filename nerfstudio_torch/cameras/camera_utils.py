"""Camera utilities (counterpart of ``nerfstudio_tpu/cameras/camera_utils.py``):
on the host, in numpy, the packed distortion parameters and the orientation
and centring of a capture's poses, which the dataparsers call; on tensors,
the lens models that ray generation calls: the Newton undistortion of
OpenCV radial and tangential distortion and the Fisheye624 projection and
its inverse. The lens models are plain PyTorch ops, float32 throughout, on
whatever device their inputs lie. Pose interpolation (camera paths) is not
ported."""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np
import torch


def get_distortion_params(
    k1: float = 0.0, k2: float = 0.0, k3: float = 0.0, k4: float = 0.0, p1: float = 0.0, p2: float = 0.0
) -> np.ndarray:
    """OpenCV radial (k1..k4) + tangential (p1, p2), packed (reference :166-170)."""
    return np.array([k1, k2, k3, k4, p1, p2], dtype=np.float32)


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking a to b (reference :223-239)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        if c > 0:
            return np.eye(3)
        # 180 deg: any perpendicular axis
        perp = np.cross(a, np.array([1.0, 0, 0]))
        if np.linalg.norm(perp) < 1e-8:
            perp = np.cross(a, np.array([0, 1.0, 0]))
        perp = perp / np.linalg.norm(perp)
        return 2.0 * np.outer(perp, perp) - np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def focus_of_attention(poses: np.ndarray, initial_focus: np.ndarray) -> np.ndarray:
    """Closest point to all camera optical axes (reference :242-267)."""
    active_directions = -poses[:, :3, 2:3]
    active_origins = poses[:, :3, 3:4]
    focus_pt = initial_focus
    active = np.sum(active_directions.squeeze(-1) * (focus_pt - active_origins.squeeze(-1)), axis=-1) > 0
    for _ in range(10):
        if active.sum() == 0:
            break
        ad = active_directions[active]
        ao = active_origins[active]
        m = np.eye(3) - ad * np.transpose(ad, (0, 2, 1))
        mt_m = np.transpose(m, (0, 2, 1)) @ m
        focus_pt = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ ao).mean(0)[:, 0]
        new_active = np.sum(active_directions.squeeze(-1) * (focus_pt - active_origins.squeeze(-1)), axis=-1) > 0
        if (new_active == active).all():
            break
        active = new_active
    return focus_pt


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: Literal["pca", "up", "vertical", "none"] = "up",
    center_method: Literal["poses", "focus", "none"] = "poses",
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient and centre (N, 3|4, 4) poses; returns (new poses, the applied
    3x4 transform) (reference :270-319)."""
    origins = poses[..., :3, 3]
    mean_origin = origins.mean(axis=0)
    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros_like(mean_origin)
    else:
        raise ValueError(center_method)

    bottom = np.broadcast_to(np.array([[0.0, 0, 0, 1]]), (len(poses), 1, 4))
    if method == "pca":
        centered = origins - mean_origin
        _, eigvec = np.linalg.eigh(centered.T @ centered)
        eigvec = np.flip(eigvec, axis=-1)
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate([eigvec.T, eigvec.T @ -translation[..., None]], axis=-1)
        # the top three rows, as the "up" branch takes them: the reference
        # stacks the bottom row under (N, 4, 4) poses too and fails there
        oriented = transform @ np.concatenate([poses[:, :3], bottom], axis=1)
        if oriented.mean(axis=0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
            transform[1:3] = -transform[1:3]
        return oriented, transform
    if method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            _, _, Vh = np.linalg.svd(poses[:, :3, 0], full_matrices=False)
            up_vertical = Vh[2, :]
            up = up_vertical if np.dot(up_vertical, up) > 0 else -up_vertical
        rotation = rotation_matrix_between(up, np.array([0.0, 0, 1]))
        transform = np.concatenate([rotation, rotation @ -translation[..., None]], axis=-1)
        oriented = transform @ np.concatenate([poses[:, :3], bottom], axis=1)
        return oriented, transform
    if method == "none":
        transform = np.eye(4)[:3]
        transform[:, 3] = -translation
        oriented = poses[:, :3].copy()
        oriented[:, :, 3] -= translation
        return oriented, transform
    raise ValueError(method)


def _compute_residual_and_jacobian(x, y, xd, yd, distortion_params):
    """The residual of the distortion at (x, y) against (xd, yd) and its
    Jacobian (reference :173-193)."""
    k1, k2, k3, k4 = (distortion_params[..., i] for i in range(4))
    p1, p2 = distortion_params[..., 4], distortion_params[..., 5]
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(
    coords: torch.Tensor, distortion_params: torch.Tensor, eps: float = 1e-3, max_iterations: int = 10
) -> torch.Tensor:
    """Distorted (..., 2) coords -> undistorted, by ``max_iterations`` Newton
    steps with no early exit; a point whose Jacobian determinant is at most
    ``eps`` in magnitude keeps its value for that step (reference :196-220).
    ``distortion_params`` (..., 6): k1..k4, p1, p2, broadcast against the
    coords' leading dimensions."""
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _compute_residual_and_jacobian(x, y, xd, yd, distortion_params)
        denom = fx_x * fy_y - fx_y * fy_x
        x_num = fx * fy_y - fy * fx_y
        y_num = fy * fx_x - fx * fy_x
        ok = torch.abs(denom) > eps
        safe = torch.where(ok, denom, torch.ones_like(denom))
        x = x - torch.where(ok, x_num / safe, torch.zeros_like(x_num))
        y = y - torch.where(ok, y_num / safe, torch.zeros_like(y_num))
    return torch.stack([x, y], dim=-1)


def fisheye624_project(xyz: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Fisheye624 projection of (..., 3) camera-space points to (..., 2)
    pixels (reference :322-351). params (..., 16): fx fy cx cy k1..k6 p1 p2
    s1..s4."""
    if params.shape[-1] != 16:
        raise ValueError(f"fisheye624 takes 16 parameters, got {params.shape[-1]}")
    eps = 1e-9
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k = params[..., 4:10]
    p1, p2 = params[..., 10], params[..., 11]
    s = params[..., 12:16]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    theta2 = theta * theta
    theta_pows = torch.stack([theta2 ** (i + 1) for i in range(6)], dim=-1)
    th_radial = 1.0 + torch.sum(theta_pows * k, dim=-1)
    th_divr = torch.where(r < eps, torch.ones_like(r), theta / torch.clamp_min(r, eps))
    xr_yr_x = torch.where(r < eps, x, th_radial * th_divr * x)
    xr_yr_y = torch.where(r < eps, y, th_radial * th_divr * y)
    r2 = xr_yr_x**2 + xr_yr_y**2
    uv_x = xr_yr_x + 2 * p1 * xr_yr_x * xr_yr_y + p2 * (r2 + 2 * xr_yr_x**2)
    uv_y = xr_yr_y + 2 * p2 * xr_yr_x * xr_yr_y + p1 * (r2 + 2 * xr_yr_y**2)
    uv_x = uv_x + s[..., 0] * r2 + s[..., 1] * r2 * r2
    uv_y = uv_y + s[..., 2] * r2 + s[..., 3] * r2 * r2
    return torch.stack([uv_x * fx + cx, uv_y * fy + cy], dim=-1)


def fisheye624_unproject(uv: torch.Tensor, params: torch.Tensor, max_iters: int = 5) -> torch.Tensor:
    """(M, 2) pixels -> (M, 3) unit rays, +z forward, by ``max_iters``
    Newton steps on ``fisheye624_project`` (reference :354-373). As the
    reference's ``jax.jacobian`` of its projection does, the Jacobian at
    every point takes the first row's parameters."""
    if params.shape[-1] != 16:
        raise ValueError(f"fisheye624 takes 16 parameters, got {params.shape[-1]}")

    def proj(xy, p):
        return fisheye624_project(torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1), p)

    first = params.reshape(-1, 16)[0]
    jac = torch.func.vmap(torch.func.jacrev(lambda p: proj(p, first)))
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    xy = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    eye = 1e-8 * torch.eye(2, dtype=uv.dtype, device=uv.device)
    for _ in range(max_iters):
        f = proj(xy, params) - uv
        J = jac(xy.reshape(-1, 2)).reshape(xy.shape[:-1] + (2, 2))
        xy = xy - torch.linalg.solve(J + eye, f[..., None])[..., 0]
    ray = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
