"""Capture-format converters -> transforms.json (counterpart of
``nerfstudio_tpu/process_data/converters.py``; reference
nerfstudio/process_data/{polycam,record3d,metashape,realitycapture,odm}_utils.py).

Pure host-side parsing of each vendor's pose and intrinsics format into the
nerfstudio transforms layout, OpenGL camera-to-world matrices in a
right-handed z-up world."""

from __future__ import annotations

import json
import math
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List

import numpy as np


def _write_transforms(output_dir: Path, frames: List[dict], **top) -> int:
    out = {"frames": frames, **top}
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "transforms.json", "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
    return len(frames)


# ---------------------------------------------------------------------------
# Polycam: keyframes/cameras/*.json with t_00..t_23 row-major 3x4 ARKit c2w
# ---------------------------------------------------------------------------


def polycam_to_json(polycam_dir: Path, output_dir: Path, min_blur_score: float = 25.0) -> int:
    polycam_dir = Path(polycam_dir)
    kf = polycam_dir / "keyframes"
    cam_dir = kf / "cameras"
    img_dir = kf / "images"
    frames = []
    for cam_file in sorted(cam_dir.iterdir()):
        with open(cam_file, encoding="utf-8") as f:
            c = json.load(f)
        if c.get("blur_score", 1e9) < min_blur_score:
            continue
        m = np.eye(4)
        for r in range(3):
            for col in range(4):
                m[r, col] = c[f"t_{r}{col}"]
        img = img_dir / f"{cam_file.stem}.jpg"
        if not img.exists():
            img = img_dir / f"{cam_file.stem}.png"
        frames.append(
            {
                "file_path": f"keyframes/images/{img.name}",
                "transform_matrix": m.tolist(),
                "fl_x": float(c["fx"]),
                "fl_y": float(c["fy"]),
                "cx": float(c["cx"]),
                "cy": float(c["cy"]),
                "w": int(c["width"]),
                "h": int(c["height"]),
            }
        )
    return _write_transforms(output_dir, frames, camera_model="OPENCV")


# ---------------------------------------------------------------------------
# Record3D: metadata json {"poses": [[qx,qy,qz,qw,px,py,pz]...], "K": 3x3
# column-major, "w", "h"}; images under rgbd/
# ---------------------------------------------------------------------------


def record3d_to_json(record3d_dir: Path, output_dir: Path) -> int:
    record3d_dir = Path(record3d_dir)
    meta_path = record3d_dir / "metadata"
    if not meta_path.exists():
        meta_path = record3d_dir / "metadata.json"
    with open(meta_path, encoding="utf-8") as f:
        meta = json.load(f)
    K = np.asarray(meta["K"], np.float64).reshape(3, 3).T  # column-major
    poses = np.asarray(meta["poses"], np.float64)  # (N, 7)
    img_dir = record3d_dir / "rgbd"
    imgs = sorted(p for p in img_dir.iterdir() if p.suffix in (".jpg", ".png"))
    frames = []
    for i, img in enumerate(imgs):
        if i >= len(poses):
            break
        qx, qy, qz, qw, px, py, pz = poses[i]
        n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
        qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
        R = np.array(
            [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
            ]
        )
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = [px, py, pz]
        frames.append(
            {
                "file_path": f"rgbd/{img.name}",
                "transform_matrix": c2w.tolist(),
            }
        )
    return _write_transforms(
        output_dir,
        frames,
        fl_x=float(K[0, 0]),
        fl_y=float(K[1, 1]),
        cx=float(K[0, 2]),
        cy=float(K[1, 2]),
        w=int(meta.get("w", round(K[0, 2] * 2))),
        h=int(meta.get("h", round(K[1, 2] * 2))),
        camera_model="OPENCV",
    )


# ---------------------------------------------------------------------------
# Metashape: cameras.xml (sensors w/ calibration, cameras w/ 4x4 transform)
# ---------------------------------------------------------------------------


def metashape_to_json(xml_path: Path, image_dir: str, output_dir: Path) -> int:
    tree = ET.parse(xml_path)
    chunk = tree.getroot().find("chunk")
    sensors = {}
    for s in chunk.find("sensors").findall("sensor"):
        calib = s.find("calibration")
        if calib is None:
            continue
        res = calib.find("resolution")
        w = int(res.get("width"))
        h = int(res.get("height"))
        f = float(calib.findtext("f"))
        # metashape cx/cy are offsets from the image center
        cx = w / 2 + float(calib.findtext("cx", "0"))
        cy = h / 2 + float(calib.findtext("cy", "0"))
        sensors[s.get("id")] = {
            "fl_x": f, "fl_y": f, "cx": cx, "cy": cy, "w": w, "h": h,
            "k1": float(calib.findtext("k1", "0")),
            "k2": float(calib.findtext("k2", "0")),
            "p1": float(calib.findtext("p1", "0")),
            "p2": float(calib.findtext("p2", "0")),
        }
    frames = []
    for cam in chunk.find("cameras").findall("camera"):
        t = cam.findtext("transform")
        if t is None or cam.get("sensor_id") not in sensors:
            continue
        m = np.fromstring(t, sep=" ").reshape(4, 4)
        m[0:3, 1:3] *= -1  # metashape uses OpenCV camera axes
        frame = {
            "file_path": f"{image_dir}/{cam.get('label')}",
            "transform_matrix": m.tolist(),
        }
        frame.update(sensors[cam.get("sensor_id")])
        frames.append(frame)
    return _write_transforms(output_dir, frames, camera_model="OPENCV")


# ---------------------------------------------------------------------------
# RealityCapture: internal/external params CSV
# ---------------------------------------------------------------------------


def realitycapture_to_json(csv_path: Path, image_dir: str, output_dir: Path) -> int:
    import csv as csv_mod

    frames = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv_mod.DictReader(f):
            name = row.get("#name") or row.get("name")
            x, y, alt = (float(row[k]) for k in ("x", "y", "alt"))
            heading, pitch, roll = (
                math.radians(float(row[k])) for k in ("heading", "pitch", "roll")
            )
            # ZXY euler (RealityCapture convention) -> rotation
            ch, sh = math.cos(heading), math.sin(heading)
            cp, sp = math.cos(pitch), math.sin(pitch)
            cr, sr = math.cos(roll), math.sin(roll)
            Rz = np.array([[ch, -sh, 0], [sh, ch, 0], [0, 0, 1]])
            Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
            Ry = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
            R = Rz @ Rx @ Ry
            c2w = np.eye(4)
            c2w[:3, :3] = R
            c2w[:3, 3] = [x, y, alt]
            c2w[0:3, 1:3] *= -1
            # f is the 35mm-equivalent focal length
            f35 = float(row["f"])
            frames.append(
                {
                    "file_path": f"{image_dir}/{name}",
                    "transform_matrix": c2w.tolist(),
                    "f35": f35,
                    "cx_frac": float(row.get("px", 0)),
                    "cy_frac": float(row.get("py", 0)),
                    "k1": float(row.get("k1", 0)),
                    "k2": float(row.get("k2", 0)),
                }
            )
    # convert 35mm focal to pixels lazily per image (needs sizes); store as
    # camera_angle_x so the blender-style loader computes per-image focals
    out_frames = []
    for fr in frames:
        f35 = fr.pop("f35")
        cxf = fr.pop("cx_frac")
        cyf = fr.pop("cy_frac")
        fr["camera_angle_x"] = 2 * math.atan(36.0 / (2 * f35))
        fr["cx_frac"] = cxf
        fr["cy_frac"] = cyf
        out_frames.append(fr)
    return _write_transforms(output_dir, out_frames, camera_model="OPENCV")


# ---------------------------------------------------------------------------
# ODM / OpenSfM: reconstruction.json
# ---------------------------------------------------------------------------


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)


def odm_to_json(reconstruction_json: Path, image_dir: str, output_dir: Path) -> int:
    with open(reconstruction_json, encoding="utf-8") as f:
        recons = json.load(f)
    recon = recons[0] if isinstance(recons, list) else recons
    cams = recon["cameras"]
    frames = []
    for name, shot in recon["shots"].items():
        cam = cams[shot["camera"]]
        R = _rodrigues(np.asarray(shot["rotation"], np.float64))  # world->cam
        t = np.asarray(shot["translation"], np.float64)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL
        w = int(cam.get("width", 0))
        h = int(cam.get("height", 0))
        # opensfm focal is normalized by max(w, h)
        focal = float(cam.get("focal", cam.get("focal_x", 1.0))) * max(w, h)
        frames.append(
            {
                "file_path": f"{image_dir}/{name}",
                "transform_matrix": c2w.tolist(),
                "fl_x": focal,
                "fl_y": focal,
                "cx": w / 2 + float(cam.get("c_x", 0)) * max(w, h),
                "cy": h / 2 + float(cam.get("c_y", 0)) * max(w, h),
                "w": w,
                "h": h,
                "k1": float(cam.get("k1", 0)),
                "k2": float(cam.get("k2", 0)),
            }
        )
    return _write_transforms(output_dir, frames, camera_model="OPENCV")
