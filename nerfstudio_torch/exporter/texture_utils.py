"""Texture baking (counterpart of ``nerfstudio_tpu/exporter/texture_utils.py``).

Each triangle gets a square chart of texels on a regular atlas grid and
the lower-left half of it as its triangle (the "polygon soup"
parameterisation: no UV unwrap library is needed); the colours come from
``query_rgb`` at the barycentric points. Host numpy, as in the reference;
the OBJ, MTL and PNG files are written byte for byte as the reference
writes them, the PNG by ``data/image_io.write_png``."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Tuple

import numpy as np

from nerfstudio_torch.data.image_io import write_png


def bake_texture(
    vertices: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (F, 3) int
    query_rgb: Callable[[np.ndarray], np.ndarray],  # (N, 3) points -> (N, 3) rgb in [0, 1]
    texels_per_tri: int = 8,
    atlas_max: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """(texture (A_h, A_w, 3) uint8, uvs (F, 3, 2) in [0, 1], v bottom-up)
    (reference :42-102). ``query_rgb`` takes up to 2,000,000 points a call."""
    f = len(faces)
    block = texels_per_tri
    per_row = max(1, int(np.ceil(np.sqrt(f))))
    atlas = min(atlas_max, per_row * block)
    per_row = atlas // block
    rows = int(np.ceil(f / per_row))
    atlas_h = rows * block
    atlas_w = per_row * block

    tex = np.zeros((atlas_h, atlas_w, 3), np.float32)
    uvs = np.zeros((f, 3, 2), np.float32)

    # the barycentric lattice of one block's lower-left triangle
    jj, ii = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    a = (ii + 0.5) / block
    b = (jj + 0.5) / block
    # the upper half folded back into the triangle
    s = a + b
    a_t = np.where(s > 1, 1 - b, a)
    b_t = np.where(s > 1, 1 - a, b)
    w0 = 1 - a_t - b_t

    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]

    # triangles in chunks, to bound the query's size
    chunkf = max(1, 2_000_000 // (block * block))
    for start in range(0, f, chunkf):
        end = min(f, start + chunkf)
        idx = np.arange(start, end)
        pts = (
            w0[None, ..., None] * v0[idx, None, None]
            + a_t[None, ..., None] * v1[idx, None, None]
            + b_t[None, ..., None] * v2[idx, None, None]
        )  # (C, block, block, 3)
        rgb = np.asarray(query_rgb(pts.reshape(-1, 3))).reshape(len(idx), block, block, 3)
        for k, fi in enumerate(idx):
            r, c = divmod(fi, per_row)
            tex[r * block : (r + 1) * block, c * block : (c + 1) * block] = rgb[k]
            u0 = (c * block + 0.5) / atlas_w
            v0_ = (r * block + 0.5) / atlas_h
            du = (block - 1.0) / atlas_w
            dv = (block - 1.0) / atlas_h
            # uv corners for the barycentric corners (w0 -> (0,0), a -> (1,0), b -> (0,1))
            uvs[fi, 0] = [u0, v0_]
            uvs[fi, 1] = [u0 + du, v0_]
            uvs[fi, 2] = [u0, v0_ + dv]

    tex_u8 = np.clip(tex * 255, 0, 255).astype(np.uint8)
    uvs[..., 1] = 1.0 - uvs[..., 1]  # an OBJ's v runs bottom-up
    return tex_u8, uvs


def export_textured_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    query_rgb: Callable[[np.ndarray], np.ndarray],
    output_dir: Path,
    name: str = "mesh",
    texels_per_tri: int = 8,
) -> None:
    """``name``.obj, .mtl and .png in ``output_dir`` (reference :105-131)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    tex, uvs = bake_texture(vertices, faces, query_rgb, texels_per_tri)
    write_png(output_dir / f"{name}.png", tex)

    with open(output_dir / f"{name}.mtl", "w") as f:
        f.write(f"newmtl baked\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}.png\n")

    lines = [f"mtllib {name}.mtl", "usemtl baked"]
    for v in vertices:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    for fi in range(len(faces)):
        for k in range(3):
            u, vv = uvs[fi, k]
            lines.append(f"vt {u:.6f} {vv:.6f}")
    for fi, face in enumerate(faces):
        t = 3 * fi
        lines.append(f"f {face[0]+1}/{t+1} {face[1]+1}/{t+2} {face[2]+1}/{t+3}")
    (output_dir / f"{name}.obj").write_text("\n".join(lines))
