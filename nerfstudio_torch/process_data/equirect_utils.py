"""Equirectangular -> perspective preprocessing on the host in numpy
(counterpart of ``nerfstudio_tpu/process_data/equirect_utils.py``; reference
nerfstudio/process_data/equirect_utils.py:86,233,323).

Turns 360-degree (equirectangular) captures into pinhole crops that the SfM
and training pipeline take. Panoramas are read and crops written as
``process_data_utils`` reads and writes images: PNG without Pillow."""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Tuple

import numpy as np

from nerfstudio_torch.process_data.process_data_utils import list_images, read_image, write_image


def _rotation_yaw_pitch(yaw: float, pitch: float) -> np.ndarray:
    """World-from-camera rotation: yaw about +y (longitude), then pitch about +x."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return ry @ rx


def _bilinear_sample(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample img[v, u] with bilinear weights; u wraps (longitude), v clamps."""
    h, w = img.shape[:2]
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0w, u1w = u0 % w, (u0 + 1) % w
    v0c = np.clip(v0, 0, h - 1)
    v1c = np.clip(v0 + 1, 0, h - 1)
    top = img[v0c, u0w] * (1 - fu) + img[v0c, u1w] * fu
    bot = img[v1c, u0w] * (1 - fu) + img[v1c, u1w] * fu
    return top * (1 - fv) + bot * fv


def equirect_to_perspective(
    img: np.ndarray, fov_deg: float, yaw_deg: float, pitch_deg: float, out_h: int, out_w: int
) -> np.ndarray:
    """Render a pinhole view (fov_deg horizontal) looking (yaw, pitch) from an
    equirectangular panorama. Pure numpy; bilinear with longitude wrap."""
    h, w = img.shape[:2]
    f = (out_w / 2.0) / math.tan(math.radians(fov_deg) / 2.0)
    xs = np.arange(out_w) - (out_w - 1) / 2.0
    ys = np.arange(out_h) - (out_h - 1) / 2.0
    x, y = np.meshgrid(xs, ys)
    # camera rays (+z forward, y down in image -> negate for elevation-up math)
    d = np.stack([x, y, np.full_like(x, f)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rot = _rotation_yaw_pitch(math.radians(yaw_deg), math.radians(pitch_deg))
    d = d @ rot.T
    lon = np.arctan2(d[..., 0], d[..., 2])  # [-pi, pi), 0 = +z
    lat = np.arcsin(np.clip(d[..., 1], -1.0, 1.0))  # [-pi/2, pi/2], + = down
    u = (lon / (2 * math.pi) + 0.5) * w - 0.5
    v = (lat / math.pi + 0.5) * h - 0.5
    out = _bilinear_sample(img.astype(np.float32), u, v)
    return out.astype(img.dtype)


def sample_view_directions(
    samples_per_image: int, crop_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
) -> List[Tuple[float, float]]:
    """(yaw, pitch) list: evenly spaced longitudes on up to 3 latitude rings.

    crop_factor = (top, bottom, left, right) fractions of the panorama to
    exclude (e.g. tripod at nadir); mirrors the reference's vertical-bound
    cropping behaviour (reference equirect_utils.py:161-230) with a simpler
    ring-pruning rule.
    """
    top, bottom, left, right = crop_factor
    rings = [(-45.0, 0.25), (0.0, 0.5), (45.0, 0.25)]  # (pitch, share)
    if top > 0:
        rings = [r for r in rings if r[0] >= -90.0 * (1 - 2 * top) or r[0] >= 0]
    if bottom > 0:
        rings = [r for r in rings if r[0] <= 90.0 * (1 - 2 * bottom) or r[0] <= 0]
    total_share = sum(s for _, s in rings)
    lon_lo = -180.0 + 360.0 * left
    lon_hi = 180.0 - 360.0 * right
    span = lon_hi - lon_lo
    views: List[Tuple[float, float]] = []
    for pitch, share in rings:
        n = max(1, round(samples_per_image * share / total_share))
        for i in range(n):
            views.append((lon_lo + span * (i + 0.5) / n, pitch))
    return views[:samples_per_image] if len(views) > samples_per_image else views


def compute_resolution_from_equirect(image_dir: Path, num_images: int) -> Tuple[int, int]:
    """Per-view pinhole resolution so that `num_images` 120-deg views roughly
    preserve the panorama's angular pixel density (reference :323)."""
    files = list_images(image_dir)
    if not files:
        raise ValueError(f"no images found in {image_dir}")
    w = read_image(files[0]).shape[1]
    side = int(w * (120.0 / 360.0) * 0.8)
    side = max(64, min(side, 1600))
    return (side, side)


def generate_planar_projections_from_equirectangular(
    image_dir: Path,
    planar_image_size: Tuple[int, int],
    samples_per_image: int,
    crop_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    fov_deg: float = 120.0,
) -> Path:
    """Write `samples_per_image` pinhole crops per panorama to
    image_dir/planar_projections (reference :233), as PNG. Returns the
    output dir."""
    out_dir = image_dir / "planar_projections"
    out_dir.mkdir(parents=True, exist_ok=True)
    views = sample_view_directions(samples_per_image, crop_factor)
    out_h, out_w = planar_image_size
    for fp in list_images(image_dir):
        pano = to_rgb(read_image(fp))
        for k, (yaw, pitch) in enumerate(views):
            persp = equirect_to_perspective(pano, fov_deg, yaw, pitch, out_h, out_w)
            write_image(out_dir / f"{fp.stem}_view{k:02d}.png", persp)
    return out_dir


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (H, W, 3), as Pillow's ``convert("RGB")``
    of an "L", "LA", "RGB" or "RGBA" image: grey repeated, alpha dropped."""
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] in (1, 2):
        return np.repeat(image[..., :1], 3, axis=-1)
    return np.ascontiguousarray(image[..., :3])
