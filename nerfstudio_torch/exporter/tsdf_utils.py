"""TSDF fusion export (counterpart of ``nerfstudio_tpu/exporter/tsdf_utils.py``).

``tsdf_fusion`` integrates depth (and colour) maps into a truncated signed
distance grid: a loop over the views of plain PyTorch ops over the (R^3,)
voxels on the device (the reference's ``lax.scan``), in the reference's
float32 operation order. ``export_tsdf_mesh`` renders train-view depths
through the pipeline, fuses them and extracts the mesh with the host's
marching cubes."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.exporter.marching_cubes import marching_cubes
from nerfstudio_torch.utils.device import resolve_device


def tsdf_fusion(
    c2ws,  # (V, 3, 4) OpenGL camera-to-world
    intrinsics,  # (V, 4) fx fy cx cy
    depths,  # (V, H, W)
    rgbs,  # (V, H, W, 3) or None
    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]],
    resolution: int = 128,
    truncation_margin: float = 4.0,
    device=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Integrate the maps (arrays or tensors) into a resolution^3 grid over
    ``aabb`` on ``device`` (None: the GPU). Returns (tsdf (R, R, R) float32,
    + outside, - inside, unobserved voxels +1; colours (R, R, R, 3) or None)
    (reference :20-105). ``truncation_margin`` is in voxel units."""
    device = resolve_device(device)
    aabb = np.asarray(aabb, np.float32)
    res = resolution
    voxel_size = float((aabb[1] - aabb[0]).max()) / res
    trunc = torch.tensor(truncation_margin * voxel_size, dtype=torch.float32, device=device)

    lin = [(np.arange(res) + 0.5) / res for _ in range(3)]
    grid = np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1)
    points = torch.from_numpy((aabb[0] + grid.reshape(-1, 3) * (aabb[1] - aabb[0])).astype(np.float32)).to(device)
    n = points.shape[0]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    c2ws, intrinsics, depths = f32(c2ws), f32(intrinsics), f32(depths)
    use_color = rgbs is not None
    rgbs = f32(rgbs) if use_color else None
    h, w = depths.shape[1:3]
    eps = f32(1e-8)
    tsdf = torch.ones((n,), dtype=torch.float32, device=device)
    weight = torch.zeros((n,), dtype=torch.float32, device=device)
    color = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for view in range(c2ws.shape[0]):
        c2w, K, depth = c2ws[view], intrinsics[view], depths[view]
        # world -> camera (OpenGL: the camera looks down -z)
        R, t = c2w[:3, :3], c2w[:3, 3]
        p_cam = (points - t) @ R  # R^T (points - t)
        z = -p_cam[:, 2]
        fx, fy, cx, cy = K[0], K[1], K[2], K[3]
        u = p_cam[:, 0] / torch.maximum(z, eps) * fx + cx
        v = -p_cam[:, 1] / torch.maximum(z, eps) * fy + cy
        # int32 truncates toward zero, as the reference's astype; clamping to
        # [-1, w] first changes no clipped index and keeps the conversion
        # inside int32
        ui = torch.clamp(torch.clamp(u, -1.0, float(w)).to(torch.int32), 0, w - 1).long()
        vi = torch.clamp(torch.clamp(v, -1.0, float(h)).to(torch.int32), 0, h - 1).long()
        valid = (z > 1e-6) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        d_obs = depth[vi, ui]
        valid = valid & (d_obs > 1e-6)
        sdf = (d_obs - z) / trunc
        valid = valid & (sdf > -1.0)
        sdf = torch.clamp(sdf, -1.0, 1.0)
        w_new = torch.where(valid, 1.0, 0.0)
        denom = torch.maximum(weight + w_new, eps)
        tsdf = (tsdf * weight + torch.where(valid, sdf, 0.0) * w_new) / denom
        if use_color:
            color = (color * weight[:, None] + rgbs[view][vi, ui] * w_new[:, None]) / denom[:, None]
        weight = weight + w_new
    tsdf = torch.where(weight > 0, tsdf, 1.0)  # unobserved voxels stay outside
    tsdf_np = tsdf.cpu().numpy().reshape(res, res, res)
    return tsdf_np, color.cpu().numpy().reshape(res, res, res, 3) if use_color else None


def export_tsdf_mesh(
    pipeline,
    state,
    output_dir,
    resolution: int = 128,
    num_views: Optional[int] = None,
    chunk_size: int = 8192,
):
    """Render train-view depths and colours in chunks of ``chunk_size`` rays,
    fuse them over the model's scene box and extract the mesh: (verts,
    faces, per-vertex colours or None) (reference :108-138)."""
    cams = pipeline.datamanager.train_cameras
    n_cams = len(cams)
    idxs = range(n_cams) if num_views is None else range(0, n_cams, max(1, n_cams // num_views))

    c2ws, Ks, depths, rgbs = [], [], [], []
    for i in idxs:
        out = pipeline.render_camera(state, cams, i, chunk_size)
        depths.append(out["depth"][..., 0])
        rgbs.append(out["rgb"])
        c2ws.append(cams.camera_to_worlds[i].to(pipeline.device))
        Ks.append([float(getattr(cams, k)[i, 0]) for k in ("fx", "fy", "cx", "cy")])

    aabb = np.asarray(pipeline.model.scene_aabb, np.float32)
    box = (tuple(aabb[0]), tuple(aabb[1]))
    tsdf, colors = tsdf_fusion(torch.stack(c2ws), np.asarray(Ks), torch.stack(depths), torch.stack(rgbs), box,
                               resolution=resolution, device=pipeline.device)
    verts, faces = marching_cubes(-tsdf, level=0.0, aabb=box)  # inside > 0
    vert_colors = None
    if colors is not None and len(verts):
        vi = (verts - aabb[0]) / (aabb[1] - aabb[0]) * (resolution - 1)
        vi = np.clip(np.round(vi).astype(int), 0, resolution - 1)
        vert_colors = colors[vi[:, 0], vi[:, 1], vi[:, 2]]
    return verts, faces, vert_colors
