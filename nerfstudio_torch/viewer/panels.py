"""Viewer panels: server-side state and actions (counterpart of
``nerfstudio_tpu/viewer/panels.py``; reference nerfstudio/viewer/
control_panel.py, render_panel.py, export_panel.py).

The browser client stays thin: panel state lives here, panel actions
(keyframe paths, offline renders, exports) run on the host around the
viewer's renders, and training-camera frustums are composited into the
rendered frame. Frames are written as PNG by ``data/image_io.write_png``
(no Pillow); the exports call the port's exporters."""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ControlPanelState:
    """(reference control_panel.py ControlPanel fields)"""

    output_type: str = "rgb"  # rgb | depth | accumulation
    max_resolution: int = 512
    train_util: float = 0.9
    show_cameras: bool = False
    paused: bool = False
    colormap: str = "turbo"  # turbo | viridis | gray
    colormap_max: float = 5.0  # depth far normalization
    depth_near: float = 0.0
    invert_colormap: bool = False
    background_color: str = "#000000"
    time: float = 0.0  # dynamic-scene (dnerf) time slider
    crop_enabled: bool = False
    crop_min: tuple = (-1.0, -1.0, -1.0)
    crop_max: tuple = (1.0, 1.0, 1.0)

    def apply(self, updates: dict) -> None:
        for k, v in updates.items():
            if hasattr(self, k):
                cur = getattr(self, k)
                if isinstance(cur, bool):
                    v = bool(v)
                elif isinstance(cur, int):
                    v = int(v)
                elif isinstance(cur, float):
                    v = float(v)
                elif isinstance(cur, tuple):
                    v = tuple(float(x) for x in v)
                setattr(self, k, v)

    def background_rgb(self) -> tuple:
        h = self.background_color.lstrip("#")
        return tuple(int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4))


class RenderPanel:
    """Keyframe collection + camera-path rendering (reference render_panel.py).

    Keyframes carry a per-keyframe fov (reference render_panel.py Keyframe
    override_fov); ``loop`` closes the path back to the first keyframe
    (reference's loop toggle)."""

    def __init__(self):
        self.keyframes: List[dict] = []  # {c2w: (3,4) list, fov: float}
        self._render_thread: Optional[threading.Thread] = None
        self.status = "idle"
        self.loop = False

    def add_keyframe(self, c2w, fov: float) -> int:
        self.keyframes.append({"c2w": np.asarray(c2w, np.float32).tolist(), "fov": float(fov)})
        return len(self.keyframes)

    def clear(self) -> None:
        self.keyframes = []

    def delete(self, index: int) -> int:
        if 0 <= index < len(self.keyframes):
            self.keyframes.pop(index)
        return len(self.keyframes)

    def set_keyframe_fov(self, index: int, fov: float) -> None:
        """Per-keyframe fov override (reference render_panel Keyframe.override_fov)."""
        if 0 <= index < len(self.keyframes):
            self.keyframes[index]["fov"] = float(fov)

    def _effective_keyframes(self) -> List[dict]:
        kfs = list(self.keyframes)
        if self.loop and len(kfs) >= 2:
            kfs.append(kfs[0])
        return kfs

    def save_path_json(self, path: Path, resolution: int = 512, fps: int = 24,
                       seconds: float = 4.0) -> Path:
        """Write a camera-path json consumable by ``nst-render camera-path``
        (reference render_panel's export to camera_path.json): raw keyframes
        plus the interpolated ``camera_path`` with 4x4 camera_to_world and a
        per-frame fov interpolated between keyframe overrides."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        n_frames = max(2, int(fps * seconds))
        cam_path = []
        if len(self.keyframes) >= 2:
            poses, fovs = self.interpolated_path(n_frames, return_fovs=True)
            for c2w, fov in zip(poses, fovs):
                m = np.eye(4, dtype=np.float32)
                m[:3] = c2w
                cam_path.append(
                    {
                        "camera_to_world": m.reshape(-1).tolist(),
                        "fov": float(fov),
                    }
                )
        payload = {
            "keyframes": self.keyframes,
            "loop": self.loop,
            "camera_path": cam_path,
            "render_height": resolution,
            "render_width": resolution,
            "fps": fps,
            "seconds": seconds,
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
        return path

    def load_path_json(self, path: Path) -> int:
        """Load keyframes back from a saved camera-path json (reference
        render_panel's 'load path' populating the keyframe list). Accepts
        both this writer's format and a bare reference-style file with only
        ``camera_path`` entries (4x4 row-major camera_to_world + fov)."""
        with open(Path(path), "r", encoding="utf-8") as f:
            payload = json.load(f)
        self.loop = bool(payload.get("loop", payload.get("is_cycle", False)))
        kfs = payload.get("keyframes")
        if kfs:
            # accept both this writer's {"c2w": 3x4, "fov": deg} shape and the
            # reference render_panel's {"matrix": flat 4x4, "fov": deg} shape
            # (reference viewer/render_panel.py:1073,1095)
            self.keyframes = []
            for k in kfs:
                if "c2w" in k:
                    c2w = np.asarray(k["c2w"], np.float32)
                else:
                    c2w = np.asarray(k["matrix"], np.float32).reshape(4, 4)[:3]
                self.keyframes.append(
                    {"c2w": c2w.tolist(), "fov": float(k.get("fov", 60.0))}
                )
        else:
            self.keyframes = []
            for fr in payload.get("camera_path", []):
                m = np.asarray(fr["camera_to_world"], np.float32).reshape(4, 4)
                self.keyframes.append(
                    {"c2w": m[:3].tolist(), "fov": float(fr.get("fov", 60.0))}
                )
        return len(self.keyframes)

    def interpolated_path(self, n_frames: int = 96, return_fovs: bool = False):
        """-> (N, 3, 4) c2w path through the keyframes (slerp + lerp),
        optionally with the per-frame lerped fov track."""
        from nerfstudio_torch.cameras import camera_utils

        kfs = self._effective_keyframes()
        assert len(kfs) >= 2, "need at least 2 keyframes"
        poses = np.asarray([k["c2w"] for k in kfs], np.float32)
        ks = np.tile(np.eye(3, dtype=np.float32), (len(poses), 1, 1))
        steps = max(2, n_frames // max(len(poses) - 1, 1))
        poses_i, _ = camera_utils.get_interpolated_poses_many(
            poses, ks, steps_per_transition=steps
        )
        poses_i = np.asarray(poses_i, np.float32)
        if not return_fovs:
            return poses_i
        # piecewise-linear fov on the SAME (segment, local-t) schedule the pose
        # interpolator uses: per segment, `steps` frames at t=linspace(0,1,steps)
        # with both endpoints included (get_interpolated_poses cadence)
        kf_fovs = np.asarray([k["fov"] for k in kfs], np.float32)
        segs = len(kfs) - 1
        j = np.arange(len(poses_i))
        seg = np.minimum(j // steps, segs - 1)
        frac = (j % steps) / max(steps - 1, 1)
        fovs = kf_fovs[seg] * (1 - frac) + kf_fovs[seg + 1] * frac
        return poses_i, fovs

    def render_path_async(self, viewer, n_frames: int, resolution: int,
                          output_dir: Path) -> None:
        """Render the keyframe path to PNG frames in a background thread,
        yielding the device between frames (reference render_panel's
        'render' button -> offline render)."""

        def _run():
            self.status = "rendering"
            try:
                from nerfstudio_torch.data.image_io import write_png

                path, fovs = self.interpolated_path(n_frames, return_fovs=True)
                out = Path(output_dir)
                out.mkdir(parents=True, exist_ok=True)
                for i, (c2w, fov) in enumerate(zip(path, fovs)):
                    cam = viewer.camera(c2w, fov, resolution)
                    write_png(out / f"frame_{i:05d}.png", to_uint8(viewer.render_view(cam, resolution)))
                    self.status = f"rendering {i + 1}/{len(path)}"
                    time.sleep(0.01)
                self.status = f"done: {out}"
            except Exception as e:  # noqa: BLE001 — the panel reports it; the viewer serves on
                self.status = f"error: {e}"

        self._render_thread = threading.Thread(target=_run, daemon=True)
        self._render_thread.start()


class ExportPanel:
    """Export actions (reference export_panel.py: pointcloud / splat / crop)."""

    def __init__(self):
        self.status = "idle"
        self._thread: Optional[threading.Thread] = None

    def export_async(self, viewer, kind: str, output_dir: Path, num_points: int = 200000):
        def _run():
            self.status = f"exporting {kind}"
            try:
                out = Path(output_dir)
                out.mkdir(parents=True, exist_ok=True)
                # the viewer's eval copy of the model and a clone of the
                # state, taken under the train lock and held for the whole
                # export (frames wait): its renders never touch the
                # training model and see one state
                with viewer.render_lock:
                    self._export(viewer, kind, out, num_points)
                self.status = f"done: {out}"
            except Exception as e:  # noqa: BLE001 — the panel reports it; the viewer serves on
                self.status = f"error: {e}"

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    @staticmethod
    def _export(viewer, kind: str, out: Path, num_points: int) -> None:
        pipeline, state = viewer.snapshot()
        if kind == "gaussian-splat":
            from nerfstudio_torch.scripts.exporter import write_splat_ply

            write_splat_ply(state.params, state.aux.alive, out / "splat.ply")
        elif kind == "cameras":
            # reference exporter.py ExportCameraPoses
            c2ws = pipeline.datamanager.train_cameras.camera_to_worlds.cpu().numpy()
            payload = [
                {"camera_to_world": np.vstack([c, [0, 0, 0, 1]]).tolist()}
                for c in c2ws
            ]
            with open(out / "transforms_train.json", "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2)
        elif kind == "tsdf":
            from nerfstudio_torch.exporter.tsdf_utils import export_tsdf_mesh
            from nerfstudio_torch.scripts.exporter import write_tsdf_mesh

            write_tsdf_mesh(out, *export_tsdf_mesh(pipeline, state, out, resolution=128, num_views=12))
        elif kind == "pointcloud":
            from nerfstudio_torch.exporter.exporter_utils import generate_point_cloud
            from nerfstudio_torch.exporter.ply_io import write_ply

            pts, rgb = generate_point_cloud(pipeline, state, num_points=num_points, max_cameras=10)
            write_ply(
                out / "pointcloud.ply",
                len(pts),
                {
                    "x": pts[:, 0].astype(np.float32),
                    "y": pts[:, 1].astype(np.float32),
                    "z": pts[:, 2].astype(np.float32),
                    "red": np.clip(rgb[:, 0] * 255, 0, 255).astype(np.uint8),
                    "green": np.clip(rgb[:, 1] * 255, 0, 255).astype(np.uint8),
                    "blue": np.clip(rgb[:, 2] * 255, 0, 255).astype(np.uint8),
                },
            )
        else:
            raise ValueError(f"unknown export kind {kind}")


def to_uint8(rgb: np.ndarray) -> np.ndarray:
    """A float image in [0, 1] -> uint8, as every viewer frame, snapshot and
    path frame is quantised: clipped, times 255, truncated."""
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def draw_camera_frustums(
    image: np.ndarray,
    view_c2w: np.ndarray,
    focal: float,
    train_c2ws: np.ndarray,
    scale: float = 0.08,
    color=(255, 180, 40),
) -> np.ndarray:
    """Composite training-camera wireframe frustums into a rendered frame
    (the reference shows frustums via viser's 3D scene; here the server
    projects + rasterizes thin lines directly)."""
    h, w = image.shape[:2]
    out = image.copy()
    R = view_c2w[:3, :3]
    t = view_c2w[:3, 3]

    def project(pts):
        cam = (pts - t) @ R  # world -> view camera
        z = -cam[:, 2]
        ok = z > 1e-6
        x = cam[:, 0] / np.maximum(z, 1e-6) * focal + w / 2
        y = -cam[:, 1] / np.maximum(z, 1e-6) * focal + h / 2
        return np.stack([x, y], -1), ok

    # frustum template in camera space (OpenGL: looking down -z)
    s = scale
    corners = np.array(
        [[0, 0, 0], [-s, -s, -2 * s], [s, -s, -2 * s], [s, s, -2 * s], [-s, s, -2 * s]]
    )
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for c2w in train_c2ws:
        pts = corners @ c2w[:3, :3].T + c2w[:3, 3]
        uv, ok = project(pts)
        for a, b in edges:
            if not (ok[a] and ok[b]):
                continue
            n = int(max(abs(uv[b, 0] - uv[a, 0]), abs(uv[b, 1] - uv[a, 1]))) + 1
            n = min(n, 4 * max(h, w))
            xs = np.linspace(uv[a, 0], uv[b, 0], n).astype(int)
            ys = np.linspace(uv[a, 1], uv[b, 1], n).astype(int)
            m = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
            out[ys[m], xs[m]] = color
    return out
