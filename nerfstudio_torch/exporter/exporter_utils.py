"""Exporter helpers (counterpart of ``nerfstudio_tpu/exporter/exporter_utils.py``):
a point cloud lifted from rendered train-view depths, with normals from the
depth map's image-space derivatives. The renders run through the
pipeline's ``render_camera`` on its device; the lifting, the subsample
(numpy's ``default_rng(0)``, as the reference draws it) and the outlier
filter run on the host in numpy."""

from __future__ import annotations

import numpy as np


def generate_point_cloud(
    pipeline,
    state,
    num_points: int = 1000000,
    remove_outliers: bool = True,
    std_ratio: float = 10.0,
    rgb_output_name: str = "rgb",
    depth_output_name: str = "depth",
    max_cameras: int = 50,
    return_normals: bool = False,
):
    """(points (N, 3), colours (N, 3) in [0, 1][, normals (N, 3)]) from the
    pixels of up to ``max_cameras`` train views whose accumulation passes
    0.5 (reference :15-70). Normals are the cross product of the lifted
    points' finite differences, turned toward the camera."""
    cams = pipeline.datamanager.train_cameras
    n_cams = min(len(cams), max_cameras)
    pts_list, rgb_list, nrm_list = [], [], []
    for i in range(n_cams):
        outputs = pipeline.render_camera(state, cams, i)
        rb = cams.generate_rays(camera_indices=i)
        depth = outputs[depth_output_name][..., 0].cpu().numpy()
        rgb = outputs[rgb_output_name].cpu().numpy()
        acc = outputs["accumulation"][..., 0].cpu().numpy() if "accumulation" in outputs else np.ones_like(depth)
        origins = rb.origins.cpu().numpy()
        dirs = rb.directions.cpu().numpy()
        pts = origins + dirs * depth[..., None]
        mask = acc > 0.5
        if return_normals:
            du = np.gradient(pts, axis=1)
            dv = np.gradient(pts, axis=0)
            nrm = np.cross(dv, du)
            nlen = np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-8)
            nrm = nrm / nlen
            # toward the camera
            flip = np.sum(nrm * dirs, axis=-1, keepdims=True) > 0
            nrm = np.where(flip, -nrm, nrm)
            nrm_list.append(nrm[mask])
        pts_list.append(pts[mask])
        rgb_list.append(rgb[mask])
    points = np.concatenate(pts_list, axis=0)
    colors = np.concatenate(rgb_list, axis=0)
    normals = np.concatenate(nrm_list, axis=0) if return_normals else None
    if len(points) > num_points:
        sel = np.random.default_rng(0).choice(len(points), num_points, replace=False)
        points, colors = points[sel], colors[sel]
        normals = normals[sel] if normals is not None else None
    if remove_outliers and len(points) > 10:
        center = points.mean(axis=0)
        d = np.linalg.norm(points - center, axis=-1)
        keep = d < d.mean() + std_ratio * d.std()
        points, colors = points[keep], colors[keep]
        normals = normals[keep] if normals is not None else None
    if return_normals:
        return points, colors, normals
    return points, colors
