"""COLMAP runs and model -> transforms.json (counterpart of
``nerfstudio_tpu/process_data/colmap_utils.py``; reference
nerfstudio/process_data/colmap_utils.py).

``run_colmap`` runs the colmap binary as subprocesses (feature extraction,
matching, mapper, bundle adjustment) and raises without it.
``colmap_to_json`` converts a COLMAP model, read by the port's
``colmap_parsing_utils``, into the nerfstudio transforms.json layout,
with the OpenCV->OpenGL camera flip and the world-axes
``applied_transform`` the nerfstudio dataparser expects."""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from nerfstudio_torch.data.dataparsers.colmap_parsing_utils import (
    qvec2rotmat,
    read_model,
)

# world-axes change folded into poses when writing transforms.json; recorded
# in the json so 3D points can be mapped into the same frame later
APPLIED_TRANSFORM = np.array(
    [[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, -1, 0]], dtype=np.float64
)

CAMERA_MODEL_PARAM_MAP = {
    # model -> (fx_idx, fy_idx, cx_idx, cy_idx, distortion mapping)
    "SIMPLE_PINHOLE": (0, 0, 1, 2, {}),
    "PINHOLE": (0, 1, 2, 3, {}),
    "SIMPLE_RADIAL": (0, 0, 1, 2, {"k1": 3}),
    "RADIAL": (0, 0, 1, 2, {"k1": 3, "k2": 4}),
    "OPENCV": (0, 1, 2, 3, {"k1": 4, "k2": 5, "p1": 6, "p2": 7}),
    "OPENCV_FISHEYE": (0, 1, 2, 3, {"k1": 4, "k2": 5, "k3": 6, "k4": 7}),
}
CAMERA_MODEL_NAME = {
    "SIMPLE_PINHOLE": "OPENCV",
    "PINHOLE": "OPENCV",
    "SIMPLE_RADIAL": "OPENCV",
    "RADIAL": "OPENCV",
    "OPENCV": "OPENCV",
    "OPENCV_FISHEYE": "OPENCV_FISHEYE",
}


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def run_colmap(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: str = "OPENCV",
    matching_method: str = "vocab_tree",
    use_gpu: bool = False,
) -> None:
    """Feature extraction -> matching -> incremental mapping (reference
    run_colmap). Requires the colmap binary on PATH."""
    if not colmap_available():
        raise RuntimeError(
            "colmap binary not found on PATH — install COLMAP or convert an "
            "existing reconstruction with colmap_to_json"
        )
    colmap_dir = Path(colmap_dir)
    colmap_dir.mkdir(parents=True, exist_ok=True)
    db = colmap_dir / "database.db"
    gpu = "1" if use_gpu else "0"
    subprocess.run(
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(image_dir),
         "--ImageReader.camera_model", camera_model,
         "--ImageReader.single_camera", "1",
         "--SiftExtraction.use_gpu", gpu],
        check=True,
    )
    matcher = {
        "exhaustive": "exhaustive_matcher",
        "sequential": "sequential_matcher",
        "vocab_tree": "exhaustive_matcher",  # vocab tree needs a downloaded tree
    }.get(matching_method, "exhaustive_matcher")
    subprocess.run(
        ["colmap", matcher, "--database_path", str(db),
         "--SiftMatching.use_gpu", gpu],
        check=True,
    )
    sparse = colmap_dir / "sparse"
    sparse.mkdir(exist_ok=True)
    subprocess.run(
        ["colmap", "mapper", "--database_path", str(db),
         "--image_path", str(image_dir), "--output_path", str(sparse)],
        check=True,
    )
    subprocess.run(
        ["colmap", "bundle_adjuster",
         "--input_path", str(sparse / "0"), "--output_path", str(sparse / "0"),
         "--BundleAdjustment.refine_principal_point", "1"],
        check=True,
    )


def colmap_to_json(
    recon_dir: Path,
    output_dir: Path,
    image_rename_map: Optional[Dict[str, str]] = None,
    ply_filename: str = "sparse_pc.ply",
) -> int:
    """COLMAP model -> transforms.json (+ sparse point PLY). Returns the
    number of registered frames (reference colmap_utils.colmap_to_json)."""
    cameras, images, points = read_model(Path(recon_dir))
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    frames = []
    for im in images.values():
        cam = cameras[im.camera_id]
        spec = CAMERA_MODEL_PARAM_MAP.get(cam.model)
        if spec is None:
            raise ValueError(f"unsupported COLMAP camera model {cam.model}")
        fxi, fyi, cxi, cyi, dist_map = spec
        # w2c -> c2w
        R = qvec2rotmat(np.asarray(im.qvec, np.float64))
        t = np.asarray(im.tvec, np.float64)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1  # OpenCV cam -> OpenGL cam
        # world axes: swap x/y, flip z (= APPLIED_TRANSFORM)
        c2w = c2w[np.array([1, 0, 2, 3]), :]
        c2w[2, :] *= -1

        name = im.name
        if image_rename_map:
            name = image_rename_map.get(name, name)
        frame = {
            "file_path": f"images/{name}",
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": im.id,
            "fl_x": float(cam.params[fxi]),
            "fl_y": float(cam.params[fyi]),
            "cx": float(cam.params[cxi]),
            "cy": float(cam.params[cyi]),
            "w": int(cam.width),
            "h": int(cam.height),
        }
        for k, idx in dist_map.items():
            frame[k] = float(cam.params[idx])
        frame["camera_model"] = CAMERA_MODEL_NAME[cam.model]
        frames.append(frame)
    frames.sort(key=lambda fr: fr["file_path"])

    out = {"frames": frames, "applied_transform": APPLIED_TRANSFORM.tolist()}
    # hoist shared intrinsics to the top level when there is a single camera
    if len(cameras) == 1:
        shared = frames[0]
        for k in ("fl_x", "fl_y", "cx", "cy", "w", "h", "camera_model",
                  "k1", "k2", "k3", "k4", "p1", "p2"):
            if k in shared:
                out[k] = shared[k]
                for fr in frames:
                    fr.pop(k, None)

    # sparse points -> PLY (seed points for splatfacto)
    xyz, rgb, _err = points
    if xyz is not None and len(xyz):
        from nerfstudio_torch.exporter.ply_io import write_ply

        write_ply(
            output_dir / ply_filename,
            len(xyz),
            {
                "x": xyz[:, 0].astype(np.float32),
                "y": xyz[:, 1].astype(np.float32),
                "z": xyz[:, 2].astype(np.float32),
                "red": rgb[:, 0].astype(np.uint8),
                "green": rgb[:, 1].astype(np.uint8),
                "blue": rgb[:, 2].astype(np.uint8),
            },
        )
        out["ply_file_path"] = ply_filename

    with open(output_dir / "transforms.json", "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
    return len(frames)
