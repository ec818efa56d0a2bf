"""COLMAP binary and text models (counterpart of
``nerfstudio_tpu/data/dataparsers/colmap_parsing_utils.py``): the cameras,
images and 3D points of a sparse reconstruction in COLMAP's ``.bin`` or
``.txt`` formats (colmap.github.io/format), parsed on the host with
``struct`` and numpy, and the text writers of cameras and images (a
capture's model can be written without COLMAP)."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

CAMERA_MODEL_IDS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_NAMES = {name: (cid, n) for cid, (name, n) in CAMERA_MODEL_IDS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read_next_bytes(f, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, f.read(num_bytes))


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (num_cameras,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num_cameras):
            cam_id, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            model_name, num_params = CAMERA_MODEL_IDS[model_id]
            params = _read_next_bytes(f, 8 * num_params, "d" * num_params)
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=model_name, width=width, height=height,
                params=np.array(params),
            )
    return cameras


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num_images,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num_images):
            vals = _read_next_bytes(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read_next_bytes(f, 8, "Q")
            data = _read_next_bytes(f, 24 * num_pts, "ddq" * num_pts)
            xys = np.array(data).reshape(-1, 3)[:, :2] if num_pts else np.zeros((0, 2))
            pids = (
                np.array(data).reshape(-1, 3)[:, 2].astype(np.int64)
                if num_pts
                else np.zeros(0, np.int64)
            )
            images[image_id] = ColmapImage(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode("utf-8"), xys=xys, point3D_ids=pids,
            )
    return images


def read_points3D_binary(path: Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz (N,3), rgb (N,3) uint8, errors (N,))."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (num_points,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num_points):
            vals = _read_next_bytes(f, 43, "QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errs.append(vals[7])
            (track_len,) = _read_next_bytes(f, 8, "Q")
            f.read(8 * track_len)
    return (
        np.array(xyzs, dtype=np.float64),
        np.array(rgbs, dtype=np.uint8),
        np.array(errs),
    )


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id = int(parts[0])
        cameras[cam_id] = ColmapCamera(
            id=cam_id, model=parts[1], width=int(parts[2]), height=int(parts[3]),
            params=np.array([float(p) for p in parts[4:]]),
        )
    return cameras


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    # NOTE: the 2D-points line of an image record may be EMPTY (zero
    # observations), so only comments may be dropped — not blank lines
    lines = [
        l.strip() for l in Path(path).read_text().splitlines()
        if not l.startswith("#")
    ]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        data = np.array([float(p) for p in pts]).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[image_id] = ColmapImage(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name,
            xys=data[:, :2], point3D_ids=data[:, 2].astype(np.int64),
        )
    return images


def read_points3D_text(path: Path):
    xyzs, rgbs, errs = [], [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        xyzs.append([float(p) for p in parts[1:4]])
        rgbs.append([int(p) for p in parts[4:7]])
        errs.append(float(parts[7]))
    return np.array(xyzs), np.array(rgbs, dtype=np.uint8), np.array(errs)


def read_model(path: Path):
    """Auto-detect bin/text model -> (cameras, images, points)."""
    path = Path(path)
    if (path / "cameras.bin").exists():
        return (
            read_cameras_binary(path / "cameras.bin"),
            read_images_binary(path / "images.bin"),
            read_points3D_binary(path / "points3D.bin"),
        )
    if (path / "cameras.txt").exists():
        return (
            read_cameras_text(path / "cameras.txt"),
            read_images_text(path / "images.txt"),
            read_points3D_text(path / "points3D.txt"),
        )
    raise FileNotFoundError(f"no COLMAP model at {path}")


def write_cameras_text(cameras: Dict[int, ColmapCamera], path: Path) -> None:
    """``cameras.txt``: one line per camera (id, model, width, height, params)."""
    lines = ["# Camera list with one line of data per camera:"]
    for cam in cameras.values():
        params = " ".join(str(p) for p in cam.params)
        lines.append(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}")
    Path(path).write_text("\n".join(lines) + "\n")


def write_images_text(images: Dict[int, ColmapImage], path: Path) -> None:
    """``images.txt``: two lines per image (id, qvec, tvec, camera id,
    name; an empty line of 2D points)."""
    lines = ["# Image list with two lines of data per image:"]
    for im in images.values():
        q = " ".join(str(v) for v in im.qvec)
        t = " ".join(str(v) for v in im.tvec)
        lines.append(f"{im.id} {q} {t} {im.camera_id} {im.name}")
        lines.append("")
    Path(path).write_text("\n".join(lines) + "\n")
