"""Camera paths for rendering (counterpart of
``nerfstudio_tpu/cameras/camera_paths.py``): a path interpolated through
given cameras, a spiral around one camera's view axis, and the viewer's
keyframe JSON. The poses are made on the host in numpy, as there, and the
``Cameras`` on the input cameras' device (the JSON path on ``device``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from nerfstudio_torch.cameras import camera_utils
from nerfstudio_torch.cameras.cameras import Cameras, CameraType

# the viewer JSON's camera_type -> the port's CameraType (reference :87-94);
# any other name is a pinhole
JSON_CAMERA_TYPES = {
    "fisheye": CameraType.FISHEYE,
    "equirectangular": CameraType.EQUIRECTANGULAR,
    "omnidirectional": CameraType.OMNIDIRECTIONALSTEREO_L,
}


def get_interpolated_camera_path(cameras: Cameras, steps: int, order_poses: bool = False) -> Cameras:
    """``steps`` cameras per transition between consecutive ``cameras``, at
    the first camera's resolution (reference :15-31)."""
    poses = cameras.camera_to_worlds.cpu().numpy()
    Ks = cameras.get_intrinsics_matrices().cpu().numpy()
    poses_i, Ks_i = camera_utils.get_interpolated_poses_many(
        poses, Ks, steps_per_transition=steps, order_poses=order_poses)
    return Cameras.create(poses_i, fx=Ks_i[:, 0, 0], fy=Ks_i[:, 1, 1], cx=Ks_i[:, 0, 2], cy=Ks_i[:, 1, 2],
                          width=int(cameras.width[0, 0]), height=int(cameras.height[0, 0]),
                          device=cameras.camera_to_worlds.device)


def get_spiral_path(
    camera: Cameras,
    steps: int = 30,
    radius: Optional[float] = None,
    radiuses=None,
    rots: int = 2,
    zrate: float = 0.5,
) -> Cameras:
    """``steps`` cameras on a spiral around the first camera of ``camera``,
    looking along its view axis, with its intrinsics (reference :34-68)."""
    assert radius is not None or radiuses is not None
    rad = np.array([radius, radius, radius]) if radiuses is None else np.asarray(radiuses)
    c2w = camera.camera_to_worlds[0].cpu().numpy()
    up = c2w[:3, 1]
    focal = float(camera.fx[0, 0])
    target = np.array([0.0, 0, -focal * 0.01])
    c2ws = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, steps + 1)[:-1]:
        center = np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate)]) * rad
        center_world = c2w[:3, 3] + c2w[:3, :3] @ center
        lookat = c2w[:3, :3] @ (center - target)
        c2ws.append(camera_utils.viewmatrix(lookat, up, center_world))
    return Cameras.create(np.stack(c2ws).astype(np.float32), fx=camera.fx[0, 0], fy=camera.fy[0, 0],
                          cx=camera.cx[0, 0], cy=camera.cy[0, 0], width=int(camera.width[0, 0]),
                          height=int(camera.height[0, 0]), device=camera.camera_to_worlds.device)


def get_path_from_json(camera_path: Dict, device=None) -> Cameras:
    """The viewer's keyframe JSON -> Cameras on ``device`` (None: the GPU),
    each with its ``render_time`` where any keyframe has one (reference
    :71-104)."""
    image_height = camera_path["render_height"]
    image_width = camera_path["render_width"]
    c2ws, fxs = [], []
    times = [] if any("render_time" in c for c in camera_path["camera_path"]) else None
    for cam in camera_path["camera_path"]:
        c2ws.append(np.array(cam["camera_to_world"], dtype=np.float32).reshape(4, 4)[:3])
        fxs.append(image_height / 2.0 / np.tan(np.deg2rad(float(cam["fov"])) / 2.0))
        if times is not None:
            times.append(cam.get("render_time", 0.0))
    camera_type = JSON_CAMERA_TYPES.get(camera_path.get("camera_type"), CameraType.PERSPECTIVE)
    return Cameras.create(np.stack(c2ws), fx=np.asarray(fxs), fy=np.asarray(fxs), cx=image_width / 2.0,
                          cy=image_height / 2.0, width=image_width, height=image_height, camera_type=camera_type,
                          device=device, times=None if times is None else np.asarray(times))
