"""Pose utilities the dataparsers call (counterpart of the host-side numpy
part of ``nerfstudio_tpu/cameras/camera_utils.py``): the packed distortion
parameters and the orientation and centring of a capture's poses.
Undistortion, pose interpolation and the fisheye624 model are not ported
(cameras with non-zero distortion raise in ``Cameras.create``)."""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np


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
