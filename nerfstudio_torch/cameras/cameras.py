"""Cameras and ray generation (counterpart of
``nerfstudio_tpu/cameras/cameras.py``).

The nine camera types of the reference: perspective and OpenCV fisheye
(with OpenCV radial and tangential distortion undone by the fixed
10-step Newton solve of ``camera_utils``), equirectangular, omnidirectional
stereo and VR180 (each eye 0.064 m apart), orthophoto and Fisheye624 (12
distortion parameters). OpenGL-convention camera-to-world matrices (x
right, y up, z back), image coords (row + 0.5, col + 0.5), and pixel area
from the finite difference of neighbouring ray directions. As the
reference does, each type present in a batch has its formula computed for
every ray and the rays take their own camera's; a batch of one type
computes that type's alone. An all-zero distortion row is the identity,
so a batch without distortion skips the Newton solve. The formulas are
plain PyTorch ops on the coords' device."""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple, Union

import torch

from nerfstudio_torch.cameras import camera_utils
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


CAMERA_MODEL_TO_TYPE = {
    "SIMPLE_PINHOLE": CameraType.PERSPECTIVE,
    "PINHOLE": CameraType.PERSPECTIVE,
    "SIMPLE_RADIAL": CameraType.PERSPECTIVE,
    "RADIAL": CameraType.PERSPECTIVE,
    "OPENCV": CameraType.PERSPECTIVE,
    "OPENCV_FISHEYE": CameraType.FISHEYE,
    "EQUIRECTANGULAR": CameraType.EQUIRECTANGULAR,
    "OMNIDIRECTIONALSTEREO_L": CameraType.OMNIDIRECTIONALSTEREO_L,
    "OMNIDIRECTIONALSTEREO_R": CameraType.OMNIDIRECTIONALSTEREO_R,
    "VR180_L": CameraType.VR180_L,
    "VR180_R": CameraType.VR180_R,
    "ORTHOPHOTO": CameraType.ORTHOPHOTO,
    "FISHEYE624": CameraType.FISHEYE624,
}
_SPHERICAL = {CameraType.EQUIRECTANGULAR.value, CameraType.OMNIDIRECTIONALSTEREO_L.value,
              CameraType.OMNIDIRECTIONALSTEREO_R.value, CameraType.VR180_L.value, CameraType.VR180_R.value}
_STEREO = _SPHERICAL - {CameraType.EQUIRECTANGULAR.value}
VR_IPD = 0.064  # metres between the stereo eyes (reference :430)


def _column(x, n: int, dtype, device) -> torch.Tensor:
    """Scalar or (n,) or (n, 1) -> (n, 1) tensor."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.ndim == 0:
        t = t.expand(n)
    return t.reshape(n, 1)


def _rotate(rotation: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v written out, so no matmul precision mode enters."""
    return rotation[..., :, 0] * v[..., 0:1] + rotation[..., :, 1] * v[..., 1:2] + rotation[..., :, 2] * v[..., 2:3]


def pose_multiply(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Compose two (..., 3, 4) rigid transforms, a @ b (reference
    ``utils/poses.multiply``)."""
    ra = pose_a[..., :3, :3]
    rot = torch.matmul(ra, pose_b[..., :3, :3])
    t = pose_a[..., :3, 3:] + torch.matmul(ra, pose_b[..., :3, 3:])
    return torch.cat([rot, t], dim=-1)


@dataclasses.dataclass
class Cameras:
    """A flat batch of N cameras (reference cameras.py:80-260)."""

    camera_to_worlds: torch.Tensor  # (N, 3, 4)
    fx: torch.Tensor  # (N, 1)
    fy: torch.Tensor  # (N, 1)
    cx: torch.Tensor  # (N, 1)
    cy: torch.Tensor  # (N, 1)
    width: torch.Tensor  # (N, 1) int
    height: torch.Tensor  # (N, 1) int
    camera_type: torch.Tensor  # (N, 1) int, CameraType values
    # (N, 6) OpenCV k1..k4, p1, p2, or (N, 12) Fisheye624 k1..k6, p1, p2,
    # s1..s4; None for none
    distortion_params: Optional[torch.Tensor] = None
    # read once on the host at construction, so that ray generation never
    # syncs the device: the camera types in the batch, and whether any
    # distortion parameter is non-zero
    types_present: Tuple[int, ...] = dataclasses.field(init=False, repr=False, compare=False)
    distorted: bool = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.types_present = tuple(sorted({int(v) for v in self.camera_type.reshape(-1).tolist()}))
        self.distorted = self.distortion_params is not None and bool(self.distortion_params.any())

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
        ``camera_type`` is one type or one per camera (CameraType members or
        their values); ``distortion_params`` one row per camera or one row
        for all."""
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
        elif not isinstance(camera_type, (int, torch.Tensor)):
            camera_type = [c.value if isinstance(c, CameraType) else int(c) for c in camera_type]
        if distortion_params is not None:
            distortion_params = torch.as_tensor(distortion_params, **f32)
            distortion_params = distortion_params.expand(n, distortion_params.shape[-1]).contiguous()
        return cls(c2w, fx, fy, cx, cy, width, height, _column(camera_type, n, **i32), distortion_params)

    def to(self, device) -> "Cameras":
        """The same cameras with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if f.init and getattr(self, f.name) is not None})

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    @property
    def is_jagged(self) -> bool:
        """Whether the cameras differ in resolution (reference :186-190)."""
        return bool((self.height != self.height[0]).any() or (self.width != self.width[0]).any())

    def get_image_coords(self, pixel_offset: float = 0.5, index: int = 0) -> torch.Tensor:
        """Dense (H, W, 2) grid of (row, col) + offset of camera ``index``
        (reference :192-217)."""
        h = int(self.height[index, 0])
        w = int(self.width[index, 0])
        dev = self.camera_to_worlds.device
        rows = torch.arange(h, dtype=torch.float32, device=dev)
        cols = torch.arange(w, dtype=torch.float32, device=dev)
        grid = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), dim=-1)
        return grid + pixel_offset

    def get_intrinsics_matrices(self) -> torch.Tensor:
        """(N, 3, 3) K matrices (reference :219-227)."""
        K = torch.zeros((len(self), 3, 3), dtype=torch.float32, device=self.fx.device)
        K[:, 0, 0], K[:, 1, 1] = self.fx[:, 0], self.fy[:, 0]
        K[:, 0, 2], K[:, 1, 2] = self.cx[:, 0], self.cy[:, 0]
        K[:, 2, 2] = 1.0
        return K

    def rescale_output_resolution(self, scaling_factor, scale_rounding_mode: str = "floor") -> "Cameras":
        """The cameras with intrinsics and sizes scaled (reference :229-250)."""
        rounding = {"floor": torch.floor, "round": torch.round, "ceil": torch.ceil}
        if scale_rounding_mode not in rounding:
            raise ValueError(scale_rounding_mode)
        rnd = rounding[scale_rounding_mode]
        sf = scaling_factor
        return dataclasses.replace(
            self, fx=self.fx * sf, fy=self.fy * sf, cx=self.cx * sf, cy=self.cy * sf,
            width=rnd(self.width * sf).to(torch.int32), height=rnd(self.height * sf).to(torch.int32))

    def generate_rays(
        self,
        camera_indices: int,
        coords: Optional[torch.Tensor] = None,
        camera_opt_to_camera: Optional[torch.Tensor] = None,
        distortion_params_delta: Optional[torch.Tensor] = None,
        disable_distortion: bool = False,
    ) -> RayBundle:
        """Rays of one camera (reference :252-318): its full image when
        ``coords`` is None, else the (..., 2) (row, col) coords given."""
        idx = int(camera_indices)
        if coords is None:
            coords = self.get_image_coords(index=idx)
        cam = torch.full(tuple(coords.shape[:-1]) + (1,), idx, dtype=torch.int32, device=coords.device)
        return self.generate_rays_from_coords(cam, coords, camera_opt_to_camera, distortion_params_delta,
                                              disable_distortion)

    def generate_rays_from_coords(
        self,
        camera_indices: torch.Tensor,
        coords: torch.Tensor,
        camera_opt_to_camera: Optional[torch.Tensor] = None,
        distortion_params_delta: Optional[torch.Tensor] = None,
        disable_distortion: bool = False,
    ) -> RayBundle:
        """Rays with a camera each (reference ``_generate_rays_from_coords``,
        cameras.py:320-548): camera_indices (..., 1) int, coords (..., 2)
        (row, col); ``camera_opt_to_camera`` (..., 3, 4) composed onto each
        ray's camera-to-world, ``distortion_params_delta`` added to its
        distortion parameters."""
        num_rays_shape = tuple(camera_indices.shape[:-1])
        if tuple(coords.shape) != num_rays_shape + (2,):
            raise ValueError(f"coords shape {tuple(coords.shape)} must be {num_rays_shape + (2,)}")
        dev = coords.device
        cam = camera_indices[..., 0].long().to(self.camera_to_worlds.device)

        def take(v):
            return v[cam].to(dev)

        tp = set(self.types_present)
        y, x = coords[..., 0], coords[..., 1]
        fx, fy, cx, cy = (take(v)[..., 0] for v in (self.fx, self.fy, self.cx, self.cy))
        cam_type = take(self.camera_type)[..., 0] if len(tp) > 1 else None
        # (3, ..., 2): the pixel and its +1 neighbours in x and in y
        coord_stack = torch.stack(
            [
                torch.stack([(x - cx) / fx, (y - cy) / fy], dim=-1),
                torch.stack([(x - cx + 1) / fx, (y - cy) / fy], dim=-1),
                torch.stack([(x - cx) / fx, (y - cy + 1) / fy], dim=-1),
            ],
            dim=0,
        )

        def is_(*types: CameraType) -> torch.Tensor:
            """Which rays' cameras are of one of ``types``."""
            if cam_type is None:
                return torch.tensor(any(t.value in tp for t in types), device=dev)
            hit = cam_type == types[0].value
            for t in types[1:]:
                hit = hit | (cam_type == t.value)
            return hit

        # the distortion: the cameras' own plus the delta (reference
        # :360-381); all-zero rows and no delta are the identity, skipped
        identity = distortion_params_delta is None and not self.distorted
        distortion = None
        if not disable_distortion and (not identity or CameraType.FISHEYE624.value in tp):
            if self.distortion_params is not None:
                distortion = take(self.distortion_params)
                if distortion_params_delta is not None:
                    distortion = distortion + distortion_params_delta.to(dev)
            elif distortion_params_delta is not None:
                distortion = distortion_params_delta.to(dev)
        if (not identity and distortion is not None and distortion.shape[-1] == 6
                and tp - {CameraType.EQUIRECTANGULAR.value, CameraType.FISHEYE624.value}):
            undistorted = camera_utils.radial_and_tangential_undistort(coord_stack, distortion[None])
            if CameraType.EQUIRECTANGULAR.value in tp:
                skip = is_(CameraType.EQUIRECTANGULAR)
                undistorted = torch.where(skip[None, ..., None], coord_stack, undistorted)
            coord_stack = undistorted

        # OpenCV -> OpenGL (reference :384)
        coord_stack = torch.stack([coord_stack[..., 0], coord_stack[..., 1] * -1.0], dim=-1)

        c2w = take(self.camera_to_worlds)  # (..., 3, 4)
        if camera_opt_to_camera is not None:
            c2w = pose_multiply(c2w, camera_opt_to_camera.to(dev))
        rotation = c2w[..., :3, :3]
        origins = c2w[..., :3, 3]

        directions = None
        for type_value, dirs in self._directions(tp, coord_stack, x, y, fx, fy, cx, cy, distortion):
            if cam_type is None:
                directions = dirs
            else:
                if directions is None:
                    directions = torch.zeros_like(dirs)
                sel = (cam_type == type_value)[None, ..., None]
                directions = torch.where(sel, dirs, directions)

        if tp & _STEREO:  # the eyes' origins on a circle (reference :427-466)
            ods = is_(CameraType.OMNIDIRECTIONALSTEREO_L, CameraType.OMNIDIRECTIONALSTEREO_R)
            vr180 = is_(CameraType.VR180_L, CameraType.VR180_R)
            right = is_(CameraType.OMNIDIRECTIONALSTEREO_R, CameraType.VR180_R)
            eye_sign = torch.where(right, 1.0, -1.0)
            ods_theta = -math.pi * ((x - cx) / fx)
            local_ods = torch.stack([torch.cos(ods_theta), torch.zeros_like(ods_theta), -torch.sin(ods_theta)],
                                    dim=-1) * (VR_IPD / 2.0)
            local_vr180 = torch.tensor([VR_IPD / 2.0, 0.0, 0.0], dtype=torch.float32, device=dev).expand(
                num_rays_shape + (3,))
            local = torch.where(ods[..., None], local_ods, 0.0) + torch.where(vr180[..., None], local_vr180, 0.0)
            world_offset = _rotate(rotation, local * eye_sign[..., None])
            origins = torch.where((ods | vr180)[..., None], origins + world_offset, origins)
        if CameraType.ORTHOPHOTO.value in tp:  # origins on the image plane (reference :467-476)
            grids = torch.stack([coord_stack[0, ..., 0], coord_stack[0, ..., 1] * -1.0], dim=-1)
            grids3 = torch.cat([grids, torch.zeros_like(grids[..., :1])], dim=-1)
            ortho = _rotate(rotation, grids3) + c2w[..., :3, 3]
            origins = torch.where(is_(CameraType.ORTHOPHOTO)[..., None], ortho, origins)

        directions = _rotate(rotation, directions)
        # summed in order in float32, as the reference's norm is
        norms = torch.sqrt(directions[..., 0:1] ** 2 + directions[..., 1:2] ** 2 + directions[..., 2:3] ** 2)
        directions = directions / torch.clamp_min(norms, 1e-10)
        dx = torch.sqrt(torch.sum((directions[0] - directions[1]) ** 2, dim=-1))
        dy = torch.sqrt(torch.sum((directions[0] - directions[2]) ** 2, dim=-1))
        return RayBundle(
            origins=origins.expand(num_rays_shape + (3,)).contiguous(),
            directions=directions[0],
            pixel_area=(dx * dy)[..., None],
            camera_indices=camera_indices[..., -1:],
            metadata={"directions_norm": norms[0]},
        )

    @staticmethod
    def _directions(tp, coord_stack, x, y, fx, fy, cx, cy, distortion):
        """(type value, (3, ..., 3) camera-space directions) for each type in
        ``tp`` (reference :401-497)."""
        if CameraType.PERSPECTIVE.value in tp:
            yield CameraType.PERSPECTIVE.value, torch.cat([coord_stack, -torch.ones_like(coord_stack[..., :1])], dim=-1)
        if CameraType.FISHEYE.value in tp:
            theta = torch.clamp(torch.sqrt(torch.sum(coord_stack**2, dim=-1)), 0.0, math.pi)
            sinc = torch.where(theta > 1e-8, torch.sin(theta) / torch.clamp_min(theta, 1e-8), 1.0)
            yield CameraType.FISHEYE.value, torch.cat([coord_stack * sinc[..., None], -torch.cos(theta)[..., None]],
                                                      dim=-1)
        if tp & _SPHERICAL:
            theta = -math.pi * coord_stack[..., 0]
            phi = math.pi * (0.5 - coord_stack[..., 1])
            dirs = torch.stack([-torch.sin(theta) * torch.sin(phi), torch.cos(phi), -torch.cos(theta) * torch.sin(phi)],
                               dim=-1)
            for t in (CameraType.EQUIRECTANGULAR, CameraType.OMNIDIRECTIONALSTEREO_L,
                      CameraType.OMNIDIRECTIONALSTEREO_R):
                if t.value in tp:
                    yield t.value, dirs
            if tp & {CameraType.VR180_L.value, CameraType.VR180_R.value}:
                theta180 = -math.pi * ((x - cx) / (fx * 2))
                dirs180 = torch.stack([-torch.sin(theta180)[None] * torch.sin(phi), torch.cos(phi),
                                       -torch.cos(theta180)[None] * torch.sin(phi)], dim=-1)
                for t in (CameraType.VR180_L, CameraType.VR180_R):
                    if t.value in tp:
                        yield t.value, dirs180
        if CameraType.ORTHOPHOTO.value in tp:
            yield CameraType.ORTHOPHOTO.value, torch.tensor(
                [0.0, 0.0, -1.0], dtype=torch.float32, device=coord_stack.device).expand(
                coord_stack.shape[:-1] + (3,))
        if CameraType.FISHEYE624.value in tp:
            if distortion is None or distortion.shape[-1] != 12:
                raise ValueError("FISHEYE624 cameras need 12 distortion parameters")
            pcoord = torch.stack([torch.stack([x, y], dim=-1), torch.stack([x + 1, y], dim=-1),
                                  torch.stack([x, y + 1], dim=-1)], dim=0)
            params = torch.cat([fx[..., None], fy[..., None], cx[..., None], cy[..., None], distortion], dim=-1)
            params = params[None].expand((3,) + params.shape)
            dirs = camera_utils.fisheye624_unproject(pcoord.reshape(-1, 2), params.reshape(-1, 16))
            # +z forward OpenCV rays -> OpenGL
            sign = torch.tensor([1.0, -1.0, -1.0], dtype=torch.float32, device=dirs.device)
            yield CameraType.FISHEYE624.value, (dirs * sign).reshape(pcoord.shape[:-1] + (3,))
