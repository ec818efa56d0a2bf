"""Cameras and ray generation (counterpart of
``nerfstudio_tpu/cameras/cameras.py``).

Perspective cameras without distortion: OpenGL-convention camera-to-world
matrices (x right, y up, z back), image coords (row + 0.5, col + 0.5), and
pixel area from the finite difference of neighbouring ray directions. The
other camera types, non-zero distortion and pose-optimiser corrections are
not ported."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import torch

from nerfstudio_torch.core.rays import RayBundle
from nerfstudio_torch.utils.device import resolve_device


class CameraType(enum.Enum):
    """Camera projection models (reference cameras.py:38-49)."""

    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3
    OMNIDIRECTIONALSTEREO_L = 4
    OMNIDIRECTIONALSTEREO_R = 5
    VR180_L = 6
    VR180_R = 7
    ORTHOPHOTO = 8
    FISHEYE624 = 9


def _column(x, n: int, dtype, device) -> torch.Tensor:
    """Scalar or (n,) or (n, 1) -> (n, 1) tensor."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.ndim == 0:
        t = t.expand(n)
    return t.reshape(n, 1)


@dataclasses.dataclass
class Cameras:
    """A flat batch of N perspective cameras (reference cameras.py:80-184)."""

    camera_to_worlds: torch.Tensor  # (N, 3, 4)
    fx: torch.Tensor  # (N, 1)
    fy: torch.Tensor  # (N, 1)
    cx: torch.Tensor  # (N, 1)
    cy: torch.Tensor  # (N, 1)
    width: torch.Tensor  # (N, 1) int
    height: torch.Tensor  # (N, 1) int
    camera_type: torch.Tensor  # (N, 1) int
    # (N, 6) OpenCV k1..k4, p1, p2, all zero (a dataparser's frames without
    # distortion keys give zeros), or None
    distortion_params: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        camera_to_worlds,
        fx,
        fy,
        cx,
        cy,
        width=None,
        height=None,
        distortion_params=None,
        camera_type: Union[CameraType, int] = CameraType.PERSPECTIVE,
        device=None,
    ) -> "Cameras":
        """Build from tensors, arrays or scalars, as the reference's
        constructor, on ``device`` (None: the GPU, ``utils.device``).
        ``distortion_params`` may be all zeros, the identity; a non-zero
        entry raises."""
        c2w = torch.as_tensor(camera_to_worlds, dtype=torch.float32, device=resolve_device(device))
        if c2w.ndim == 2:
            c2w = c2w[None]
        n = c2w.shape[0]
        f32 = dict(dtype=torch.float32, device=c2w.device)
        fx, fy, cx, cy = (_column(v, n, **f32) for v in (fx, fy, cx, cy))
        i32 = dict(dtype=torch.int32, device=c2w.device)
        width = (cx * 2).to(torch.int32) if width is None else _column(width, n, **i32)
        height = (cy * 2).to(torch.int32) if height is None else _column(height, n, **i32)
        if isinstance(camera_type, CameraType):
            camera_type = camera_type.value
        if distortion_params is not None:
            distortion_params = torch.as_tensor(distortion_params, **f32).reshape(n, 6)
            if bool(distortion_params.any()):
                raise NotImplementedError("camera distortion is not ported (non-zero distortion_params)")
        return cls(c2w, fx, fy, cx, cy, width, height, _column(camera_type, n, **i32), distortion_params)

    def to(self, device) -> "Cameras":
        """The same cameras with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})

    def all_perspective(self) -> bool:
        """Whether every camera is perspective (read once, then cached: the
        check would otherwise sync the device on every batch)."""
        if not hasattr(self, "_all_perspective"):
            self._all_perspective = bool((self.camera_type == CameraType.PERSPECTIVE.value).all())
        return self._all_perspective

    def get_image_coords(self, pixel_offset: float = 0.5, index: int = 0) -> torch.Tensor:
        """Dense (H, W, 2) grid of (row, col) + offset (reference :206-217)."""
        h = int(self.height[index, 0])
        w = int(self.width[index, 0])
        dev = self.camera_to_worlds.device
        rows = torch.arange(h, dtype=torch.float32, device=dev)
        cols = torch.arange(w, dtype=torch.float32, device=dev)
        grid = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), dim=-1)
        return grid + pixel_offset

    def generate_rays(
        self,
        camera_indices: int,
        coords: Optional[torch.Tensor] = None,
        camera_opt_to_camera: Optional[torch.Tensor] = None,
        distortion_params_delta: Optional[torch.Tensor] = None,
        disable_distortion: bool = False,
    ) -> RayBundle:
        """Rays of one camera (reference :252-318): its full image when
        ``coords`` is None, else the (..., 2) (row, col) coords given. The
        camera-opt correction and distortion deltas are not ported here
        (nerfacto applies its camera-opt to the ray bundle)."""
        if camera_opt_to_camera is not None or distortion_params_delta is not None:
            raise NotImplementedError("camera-opt corrections and distortion deltas are not ported")
        idx = int(camera_indices)
        if coords is None:
            coords = self.get_image_coords(index=idx)
        cam = torch.full(tuple(coords.shape[:-1]) + (1,), idx, dtype=torch.int32, device=coords.device)
        return self.generate_rays_from_coords(cam, coords)

    def generate_rays_from_coords(self, camera_indices: torch.Tensor, coords: torch.Tensor) -> RayBundle:
        """Rays with a camera each (reference ``_generate_rays_from_coords``,
        cameras.py:320-548, perspective without distortion):
        camera_indices (..., 1) int, coords (..., 2) (row, col)."""
        num_rays_shape = tuple(camera_indices.shape[:-1])
        if tuple(coords.shape) != num_rays_shape + (2,):
            raise ValueError(f"coords shape {tuple(coords.shape)} must be {num_rays_shape + (2,)}")
        if not self.all_perspective():
            raise NotImplementedError("only perspective cameras are ported")
        cam = camera_indices[..., 0].long().to(self.camera_to_worlds.device)
        y, x = coords[..., 0], coords[..., 1]
        fx, fy, cx, cy = (v[cam, 0].to(coords.device) for v in (self.fx, self.fy, self.cx, self.cy))
        # (3, ..., 2): the pixel and its +1 neighbours in x and in y
        coord_stack = torch.stack(
            [
                torch.stack([(x - cx) / fx, (y - cy) / fy], dim=-1),
                torch.stack([(x - cx + 1) / fx, (y - cy) / fy], dim=-1),
                torch.stack([(x - cx) / fx, (y - cy + 1) / fy], dim=-1),
            ],
            dim=0,
        )
        # OpenCV -> OpenGL (reference :384)
        coord_stack = torch.stack([coord_stack[..., 0], coord_stack[..., 1] * -1.0], dim=-1)
        dirs = torch.cat([coord_stack, -torch.ones_like(coord_stack[..., :1])], dim=-1)
        c2w = self.camera_to_worlds[cam].to(coords.device)  # (..., 3, 4)
        rotation = c2w[..., :3, :3]
        # R @ d written out, so no matmul precision mode enters
        dirs = (
            rotation[..., :, 0] * dirs[..., 0:1]
            + rotation[..., :, 1] * dirs[..., 1:2]
            + rotation[..., :, 2] * dirs[..., 2:3]
        )
        # summed in order in float32, as the reference's norm is
        norms = torch.sqrt(dirs[..., 0:1] ** 2 + dirs[..., 1:2] ** 2 + dirs[..., 2:3] ** 2)
        dirs = dirs / torch.clamp_min(norms, 1e-10)
        directions = dirs[0]
        dx = torch.sqrt(torch.sum((directions - dirs[1]) ** 2, dim=-1))
        dy = torch.sqrt(torch.sum((directions - dirs[2]) ** 2, dim=-1))
        return RayBundle(
            origins=c2w[..., :3, 3].contiguous(),
            directions=directions,
            pixel_area=(dx * dy)[..., None],
            camera_indices=camera_indices[..., -1:],
            metadata={"directions_norm": norms[0]},
        )
