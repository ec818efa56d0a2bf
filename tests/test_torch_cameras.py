"""The port's cameras and lens models against the JAX package's on the same
inputs (numpy, from a seed): ray generation for every camera type and for
one batch mixing them, with and without a camera-opt pose correction and a
distortion delta (origins, directions, pixel area and direction norms
within 1e-5 abs); the Newton undistortion, including points where its
Jacobian's determinant is under eps; the Fisheye624 projection and its
inverse; jagged image coords, intrinsics matrices and rescaling."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU
from nerfstudio_tpu.cameras import camera_utils as jcu
from nerfstudio_tpu.cameras.cameras import CAMERA_MODEL_TO_TYPE as J_MODEL_TO_TYPE
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_torch.cameras import camera_utils as tcu
from nerfstudio_torch.cameras.cameras import CAMERA_MODEL_TO_TYPE, Cameras, CameraType

ATOL = 1e-5
HW = (12, 16)  # (H, W)
OPENCV = np.array([-0.18, 0.04, 0.01, -0.002, 1e-3, -2e-3], np.float32)  # all six OpenCV terms
FISHEYE = np.array([0.05, -0.01, 0.002, -1e-4, 0.0, 0.0], np.float32)
FISHEYE624 = np.array([0.03, -0.01, 0.002, -1e-4, 1e-5, -1e-6, 1e-3, -5e-4, 2e-4, -1e-4, 1e-4, -5e-5], np.float32)


def _c2w(n, seed=0):
    """n random rigid camera-to-world matrices."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return np.concatenate([q, rng.uniform(-2, 2, (n, 3, 1))], axis=-1).astype(np.float32)


def _pair(types, distortion=None, sizes=None, seed=0):
    """(JAX cameras, the port's) of len(types) cameras: random poses,
    intrinsics about the image centre, ``distortion`` per camera."""
    n = len(types)
    rng = np.random.default_rng(seed + 1)
    h, w = (np.array([s[0] for s in sizes]), np.array([s[1] for s in sizes])) if sizes else (
        np.full(n, HW[0]), np.full(n, HW[1]))
    fx = rng.uniform(10, 14, n).astype(np.float32)
    fy = rng.uniform(10, 14, n).astype(np.float32)
    cx = (w / 2 + rng.uniform(-1, 1, n)).astype(np.float32)
    cy = (h / 2 + rng.uniform(-1, 1, n)).astype(np.float32)
    ctype = np.array([t.value for t in types], np.int32)
    c2w = _c2w(n, seed)
    d = None if distortion is None else np.ascontiguousarray(np.broadcast_to(distortion, (n, distortion.shape[-1])))
    j = JCameras(camera_to_worlds=c2w, fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h, distortion_params=d,
                 camera_type=ctype)
    t = Cameras.create(c2w, fx, fy, cx, cy, w, h, distortion_params=d, camera_type=torch.from_numpy(ctype),
                       device=CPU)
    return j, t


def _opt_pose(n, seed=5):
    """Small random SE(3) corrections, (n, 3, 4)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.05, (n, 3))
    out = np.zeros((n, 3, 4), np.float32)
    for i, v in enumerate(a):
        k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        th = np.linalg.norm(v)
        out[i, :, :3] = np.eye(3) + np.sin(th) / th * k + (1 - np.cos(th)) / th**2 * k @ k
        out[i, :, 3] = rng.normal(0, 0.02, 3)
    return out


def _assert_bundles(trb, jrb):
    for name in ("origins", "directions", "pixel_area"):
        np.testing.assert_allclose(getattr(trb, name).numpy(), np.asarray(getattr(jrb, name)), rtol=0, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(trb.metadata["directions_norm"].numpy(), np.asarray(jrb.metadata["directions_norm"]),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(trb.camera_indices.numpy(), np.asarray(jrb.camera_indices))


def _rays_from_indices(j, t, idx, opt=None, delta=None):
    """Both packages' rays for (camera, row, col) rows ``idx``."""
    coords = np.stack([idx[:, 1] + 0.5, idx[:, 2] + 0.5], axis=-1).astype(np.float32)
    jrb = j._generate_rays_from_coords(jnp.asarray(idx[:, :1]), jnp.asarray(coords),
                                       None if opt is None else jnp.asarray(opt),
                                       None if delta is None else jnp.asarray(delta))
    trb = t.generate_rays_from_coords(torch.from_numpy(idx[:, :1]), torch.from_numpy(coords),
                                      None if opt is None else torch.from_numpy(opt),
                                      None if delta is None else torch.from_numpy(delta))
    return jrb, trb


TYPES = {
    "perspective_opencv": (CameraType.PERSPECTIVE, OPENCV),
    "perspective_plain": (CameraType.PERSPECTIVE, None),
    "fisheye": (CameraType.FISHEYE, FISHEYE),
    "equirectangular": (CameraType.EQUIRECTANGULAR, None),
    "ods_l": (CameraType.OMNIDIRECTIONALSTEREO_L, None),
    "ods_r": (CameraType.OMNIDIRECTIONALSTEREO_R, None),
    "vr180_l": (CameraType.VR180_L, None),
    "vr180_r": (CameraType.VR180_R, None),
    "orthophoto": (CameraType.ORTHOPHOTO, None),
    "fisheye624": (CameraType.FISHEYE624, FISHEYE624),
}


@pytest.mark.parametrize("kind", list(TYPES))
def test_full_image_rays_of_every_type(kind):
    """``generate_rays`` of one camera's full image."""
    ctype, d = TYPES[kind]
    j, t = _pair([ctype] * 2, d)
    jrb, trb = j.generate_rays(camera_indices=1), t.generate_rays(camera_indices=1)
    assert trb.origins.shape == tuple(jrb.origins.shape)
    _assert_bundles(trb, jrb)


@pytest.mark.parametrize("with_opt", [False, True], ids=["no_opt", "camera_opt"])
@pytest.mark.parametrize("with_delta", [False, True], ids=["no_delta", "delta"])
@pytest.mark.parametrize("kind", ["mixed", "perspective_opencv", "fisheye624"])
def test_rays_with_opt_and_delta(kind, with_opt, with_delta):
    """Random pixels with a camera each, with a pose correction per ray and
    a distortion delta; ``mixed`` holds every type but Fisheye624 (which
    needs 12 parameters where the others take 6) in one batch."""
    if kind == "mixed":
        types = [TYPES[k][0] for k in TYPES if k != "fisheye624"]
        j, t = _pair(types, OPENCV)
    else:
        j, t = _pair([TYPES[kind][0]] * 3, TYPES[kind][1])
    rng = np.random.default_rng(7)
    n = 96
    cam = rng.integers(0, len(t), n)
    idx = np.stack([cam, rng.integers(0, HW[0], n), rng.integers(0, HW[1], n)], axis=-1).astype(np.int32)
    opt = _opt_pose(n) if with_opt else None
    width = t.distortion_params.shape[-1]
    delta = rng.normal(0, 1e-3, (n, width)).astype(np.float32) if with_delta else None
    jrb, trb = _rays_from_indices(j, t, idx, opt, delta)
    _assert_bundles(trb, jrb)


def test_disable_distortion_and_zero_rows():
    """``disable_distortion`` gives the pinhole rays; all-zero distortion
    rows give the same rays as no distortion (the port skips the solve)."""
    j, t = _pair([CameraType.PERSPECTIVE] * 2, OPENCV)
    _assert_bundles(t.generate_rays(0, disable_distortion=True), j.generate_rays(0, disable_distortion=True))
    _, zero = _pair([CameraType.PERSPECTIVE] * 2, np.zeros(6, np.float32))
    jn, none = _pair([CameraType.PERSPECTIVE] * 2)
    assert zero.distorted is False and t.distorted is True
    a, b = zero.generate_rays(1), none.generate_rays(1)
    assert torch.equal(a.directions, b.directions) and torch.equal(a.pixel_area, b.pixel_area)
    _assert_bundles(a, jn.generate_rays(camera_indices=1))


def test_radial_and_tangential_undistort_matches_jax():
    """Random distorted points, and points where the determinant of the
    Jacobian is under eps (a strongly negative k1 folds the model over at
    r^2 = -1/(3 k1)), where the reference keeps the point for that step."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.2, 1.2, (512, 2)).astype(np.float32)
    d = np.ascontiguousarray(np.broadcast_to(OPENCV, (512, 6)))
    ref = np.asarray(jcu.radial_and_tangential_undistort(jnp.asarray(pts), jnp.asarray(d)))
    out = tcu.radial_and_tangential_undistort(torch.from_numpy(pts), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    # k1 = -1: the determinant at (x, 0) is (1 - 3x^2)(1 - x^2), zero at
    # x^2 = 1/3 and 1
    fold = np.zeros((64, 6), np.float32)
    fold[:, 0] = -1.0
    xs = np.concatenate([np.float32(1 / 3) ** 0.5 + rng.normal(0, 1e-5, 32), 1 + rng.normal(0, 1e-5, 32)])
    pts = np.stack([xs, np.zeros_like(xs)], axis=-1).astype(np.float32)
    _, _, fx_x, fx_y, fy_x, fy_y = tcu._compute_residual_and_jacobian(
        torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]), 0, 0, torch.from_numpy(fold))
    assert bool(((fx_x * fy_y - fx_y * fy_x).abs() <= 1e-3).any())
    ref = np.asarray(jcu.radial_and_tangential_undistort(jnp.asarray(pts), jnp.asarray(fold)))
    out = tcu.radial_and_tangential_undistort(torch.from_numpy(pts), torch.from_numpy(fold)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_fisheye624_project_and_unproject_match_jax():
    rng = np.random.default_rng(4)
    xyz = np.concatenate([rng.normal(0, 0.5, (256, 2)), rng.uniform(0.5, 2, (256, 1))], axis=-1).astype(np.float32)
    xyz[0, :2] = 0.0  # r < eps
    params = np.concatenate([[200.0, 210.0, 128.0, 120.0], FISHEYE624]).astype(np.float32)
    params = np.ascontiguousarray(np.broadcast_to(params, (256, 16)))
    ref = np.asarray(jcu.fisheye624_project(jnp.asarray(xyz), jnp.asarray(params)))
    out = tcu.fisheye624_project(torch.from_numpy(xyz), torch.from_numpy(params)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    uv = rng.uniform(20, 236, (256, 2)).astype(np.float32)
    ref = np.asarray(jcu.fisheye624_unproject(jnp.asarray(uv), jnp.asarray(params)))
    out = tcu.fisheye624_unproject(torch.from_numpy(uv), torch.from_numpy(params)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_jagged_coords_intrinsics_and_rescale():
    sizes = [(12, 16), (10, 14), (12, 16)]
    j, t = _pair([CameraType.PERSPECTIVE] * 3, sizes=sizes)
    assert t.is_jagged == j.is_jagged is True
    assert _pair([CameraType.PERSPECTIVE] * 2)[1].is_jagged is False
    for i in range(3):
        np.testing.assert_array_equal(t.get_image_coords(index=i).numpy(), np.asarray(j.get_image_coords(index=(i,))))
        _assert_bundles(t.generate_rays(i), j.generate_rays(camera_indices=i))
    np.testing.assert_array_equal(t.get_intrinsics_matrices().numpy(), np.asarray(j.get_intrinsics_matrices()))
    for mode in ("floor", "round", "ceil"):
        jr, tr = j.rescale_output_resolution(0.37, mode), t.rescale_output_resolution(0.37, mode)
        for f in ("fx", "fy", "cx", "cy", "width", "height"):
            np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), err_msg=f"{mode} {f}")


def test_camera_model_names_map_as_jax():
    assert {k: v.value for k, v in CAMERA_MODEL_TO_TYPE.items()} == {k: v.value for k, v in J_MODEL_TO_TYPE.items()}
