"""Whole-image undistortion for the full-image (splatfacto) data path
(counterpart of ``nerfstudio_tpu/data/undistort.py``).

On the host, in numpy float64, as the reference: for every output
(undistorted) pixel the forward distortion model gives its source pixel in
the distorted image, which is sampled bilinearly. The output keeps the
same intrinsics (fx, fy, cx, cy); no new camera matrix is computed. Models:
OpenCV radial and tangential (k1..k4, p1, p2) for perspective cameras and
the equidistant fisheye (k1..k4) for fisheye cameras."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nerfstudio_torch.cameras.cameras import Cameras, CameraType


def _bilinear_sample(image: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = image.shape[:2]
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    img = image.astype(np.float32)
    out = (
        img[y0c, x0c] * (1 - wx) * (1 - wy)
        + img[y0c, x1c] * wx * (1 - wy)
        + img[y1c, x0c] * (1 - wx) * wy
        + img[y1c, x1c] * wx * wy
    )
    return np.where(inside[..., None], out, 0.0)


def _distort_opencv(xn, yn, d):
    k1, k2, k3, k4, p1, p2 = (float(d[i]) for i in range(6))
    r2 = xn * xn + yn * yn
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    x_d = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    y_d = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return x_d, y_d


def _distort_fisheye(xn, yn, d):
    k1, k2, k3, k4 = (float(d[i]) for i in range(4))
    r = np.sqrt(xn * xn + yn * yn)
    theta = np.arctan(r)
    theta_d = theta * (1 + k1 * theta**2 + k2 * theta**4 + k3 * theta**6 + k4 * theta**8)
    scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
    return xn * scale, yn * scale


def undistort_image(image: np.ndarray, fx: float, fy: float, cx: float, cy: float, distortion_params: np.ndarray,
                    camera_type: int = CameraType.PERSPECTIVE.value) -> np.ndarray:
    """Undistort an (H, W, C) image: the same size and dtype, under the same
    intrinsics, with identity distortion (reference :64-89)."""
    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    xn = (xs + 0.5 - cx) / fx
    yn = (ys + 0.5 - cy) / fy
    if camera_type == CameraType.FISHEYE.value:
        x_d, y_d = _distort_fisheye(xn, yn, distortion_params)
    else:
        d6 = np.zeros(6)
        d6[: min(6, len(distortion_params))] = distortion_params[:6]
        x_d, y_d = _distort_opencv(xn, yn, d6)
    src_x = x_d * fx + cx - 0.5
    src_y = y_d * fy + cy - 0.5
    out = _bilinear_sample(image, src_x, src_y)
    if np.issubdtype(image.dtype, np.integer):
        return np.clip(np.round(out), 0, 255).astype(image.dtype)
    return out.astype(image.dtype)


def undistort_view(image: np.ndarray, cameras: Cameras, idx: int) -> np.ndarray:
    """``undistort_image`` of camera ``idx``'s image; the image itself where
    the camera has no distortion."""
    d = cameras.distortion_params
    if d is None:
        return image
    d = d[idx].cpu().numpy().reshape(-1)
    if not np.any(np.abs(d) > 1e-12):
        return image
    fx, fy, cx, cy = (float(getattr(cameras, f)[idx, 0]) for f in ("fx", "fy", "cx", "cy"))
    return undistort_image(image, fx, fy, cx, cy, d, int(cameras.camera_type[idx, 0]))


def maybe_undistort_dataset(images: np.ndarray, cameras: Cameras) -> Tuple[np.ndarray, Cameras]:
    """Undistort an (N, H, W, C) stack whose cameras carry distortion:
    (images, the cameras with all-zero distortion) (reference :92-113)."""
    d = cameras.distortion_params
    if d is None:
        return images, cameras
    d_np = d.cpu().numpy()
    if not np.any(np.abs(d_np) > 1e-12):
        return images, cameras
    fx, fy, cx, cy = (getattr(cameras, f).cpu().numpy().reshape(-1) for f in ("fx", "fy", "cx", "cy"))
    ctype = cameras.camera_type.cpu().numpy().reshape(-1)
    out = np.empty_like(images)
    for i in range(images.shape[0]):
        out[i] = undistort_image(images[i], fx[i], fy[i], cx[i], cy[i], d_np[i].reshape(-1), int(ctype[i]))
    return out, dataclasses.replace(cameras, distortion_params=torch.zeros_like(d))
