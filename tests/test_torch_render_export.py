"""The port's render and export modules against the JAX package's on the
same inputs (numpy, from a seed): the camera-path helpers (exact), the
viewer JSON of a camera, the three camera paths (1e-6) and their rays
(1e-5), the colormaps (1e-6; PCA per channel up to c <-> 1 - c), marching
cubes on a sphere SDF and a noisy volume and through a field on a grid
(verts and faces exact), TSDF fusion of a sphere's depth maps (1e-5 where
both observe, the observed masks equal on >= 99.9% of voxels), the Poisson
solve (chi 1e-4 of its peak, iso 1e-4 relative), the texture bake with an
analytic colour (atlas and UVs exact, OBJ/MTL/PNG byte-equal), the PLY
writer and the splat PLY (byte-equal), and the point cloud of a tiny
nerfacto built from JAX params (the tolerance of
test_torch_nerfacto_render.py, K1 neutral)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import CPU, HW, NUM_IMAGES, init_params, jax_tiny_nerfacto, orbit_c2w, sphere_grid_binary
from _torch_port import torch_tiny_nerfacto
from nerfstudio_tpu.cameras import camera_paths as jpaths
from nerfstudio_tpu.cameras import camera_utils as jcu
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.exporter import exporter_utils as jexu
from nerfstudio_tpu.exporter import marching_cubes as jmc
from nerfstudio_tpu.exporter import ply_io as jply
from nerfstudio_tpu.exporter import poisson as jpoisson
from nerfstudio_tpu.exporter import texture_utils as jtex
from nerfstudio_tpu.exporter import tsdf_utils as jtsdf
from nerfstudio_tpu.models.base_model import render_camera as j_render_camera
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_tpu.utils import colormaps as jcm
from nerfstudio_torch.cameras import camera_paths as tpaths
from nerfstudio_torch.cameras import camera_utils as tcu
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.exporter import exporter_utils as texu
from nerfstudio_torch.exporter import marching_cubes as tmc
from nerfstudio_torch.exporter import ply_io as tply
from nerfstudio_torch.exporter import poisson as tpoisson
from nerfstudio_torch.exporter import texture_utils as ttex
from nerfstudio_torch.exporter import tsdf_utils as ttsdf
from nerfstudio_torch.models.base_model import render_camera
from nerfstudio_torch.utils import colormaps as tcm
from nerfstudio_torch.utils.convert import occupancy_from_jax, params_from_jax


def _rotations(n, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _poses(n, seed=0):
    rng = np.random.default_rng(seed + 1)
    return np.concatenate([_rotations(n, seed), rng.uniform(-2, 2, (n, 3, 1))], axis=-1)


def _ks(n, seed=0):
    rng = np.random.default_rng(seed + 2)
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(10, 14, n), rng.uniform(10, 14, n)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = rng.uniform(7, 9, n), rng.uniform(5, 7, n), 1.0
    return K


# --------------------------------------------------------------------------
# camera utilities and paths


def test_quaternion_helpers_are_exact():
    rng = np.random.default_rng(3)
    for R in _rotations(6, seed=3):
        q = tcu.quaternion_from_matrix(R)
        np.testing.assert_array_equal(q, jcu.quaternion_from_matrix(R))
        np.testing.assert_array_equal(tcu.quaternion_matrix(q), jcu.quaternion_matrix(q))
        q1 = rng.normal(size=4)
        for t in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(tcu.quaternion_slerp(q, q1, t), jcu.quaternion_slerp(q, q1, t))
    q = rng.normal(size=4)
    near = q * (1 + 1e-9)  # theta under float32's 4 eps: the normalised lerp
    np.testing.assert_array_equal(tcu.quaternion_slerp(q, near, 0.4), jcu.quaternion_slerp(q, near, 0.4))
    np.testing.assert_array_equal(tcu.quaternion_matrix(np.zeros(4)), jcu.quaternion_matrix(np.zeros(4)))
    data = rng.normal(size=(4, 3))
    np.testing.assert_array_equal(tcu.unit_vector(data[0]), jcu.unit_vector(data[0]))
    np.testing.assert_array_equal(tcu.unit_vector(data, axis=1), jcu.unit_vector(data, axis=1))


def test_pose_interpolation_and_look_at_are_exact():
    poses, Ks = _poses(5).astype(np.float32), _ks(5)
    for a, b in zip(tcu.get_interpolated_poses(poses[0], poses[1], 7),
                    jcu.get_interpolated_poses(poses[0], poses[1], 7)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcu.get_interpolated_k(Ks[0], Ks[1], 5), jcu.get_interpolated_k(Ks[0], Ks[1], 5)):
        np.testing.assert_array_equal(a, b)
    for got, ref in zip(tcu.get_ordered_poses_and_k(poses, Ks), jcu.get_ordered_poses_and_k(poses, Ks)):
        np.testing.assert_array_equal(got, ref)
    for order in (False, True):
        for got, ref in zip(tcu.get_interpolated_poses_many(poses, Ks, 4, order),
                            jcu.get_interpolated_poses_many(poses, Ks, 4, order)):
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 3))
    np.testing.assert_array_equal(tcu.normalize(x[0]), jcu.normalize(x[0]))
    for got, ref in zip(tcu.normalize_with_norm(x, -1), jcu.normalize_with_norm(x, -1)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tcu.viewmatrix(x[0], x[1], x[2]), jcu.viewmatrix(x[0], x[1], x[2]))


def _camera_pair(n=4, times=None):
    c2w = _poses(n, seed=7).astype(np.float32)
    K = _ks(n, seed=7)
    args = (c2w, K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], np.full(n, 16), np.full(n, 12))
    return JCameras(*args, times=times), Cameras.create(*args, device=CPU, times=times)


def test_camera_to_json_matches():
    for times in (None, np.linspace(0, 1, 4).astype(np.float32)):
        jcams, tcams = _camera_pair(times=times)
        for i in range(4):
            assert json.dumps(tcams.to_json(i)) == json.dumps(jcams.to_json(i))


def _assert_cameras(t, j, rays=True):
    """Every field within 1e-6 (JAX's may lack the trailing unit axis, as
    its spiral's intrinsics do), and every camera's rays within 1e-5."""
    assert len(t) == j.camera_to_worlds.shape[0]

    def field(name):
        return getattr(t, name).numpy(), np.asarray(getattr(j, name)).reshape(getattr(t, name).shape)

    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(*field(name), rtol=0, atol=1e-6, err_msg=name)
    for name in ("width", "height", "camera_type"):
        np.testing.assert_array_equal(*field(name), err_msg=name)
    assert (t.times is None) == (j.times is None)
    if t.times is not None:
        np.testing.assert_allclose(t.times.numpy(), np.asarray(j.times), rtol=0, atol=1e-6)
    # JAX's rays from its fields as JAX lays out a camera batch (its
    # spiral's (N,) intrinsics do not broadcast against the image grid)
    j = JCameras(*(field(name)[1] for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height")),
                 camera_type=field("camera_type")[1], times=None if j.times is None else np.asarray(j.times))
    for i in range(len(t)) if rays else ():
        trb, jrb = t.generate_rays(i), j.generate_rays(camera_indices=i)
        for name in ("origins", "directions", "pixel_area"):
            np.testing.assert_allclose(getattr(trb, name).numpy(), np.asarray(getattr(jrb, name)), rtol=0,
                                       atol=1e-5, err_msg=f"camera {i} {name}")
        if t.times is not None:
            np.testing.assert_allclose(trb.times.numpy(), np.asarray(jrb.times), rtol=0, atol=1e-6)


@pytest.mark.parametrize("order", [False, True])
def test_interpolated_path_matches(order):
    jcams, tcams = _camera_pair()
    _assert_cameras(tpaths.get_interpolated_camera_path(tcams, 3, order),
                    jpaths.get_interpolated_camera_path(jcams, 3, order))


@pytest.mark.parametrize("radius", [0.1, (0.1, 0.2, 0.05)])
def test_spiral_path_matches(radius):
    jcams, tcams = _camera_pair()
    kw = dict(radius=radius) if isinstance(radius, float) else dict(radiuses=radius)
    _assert_cameras(tpaths.get_spiral_path(tcams, steps=5, **kw), jpaths.get_spiral_path(jcams, steps=5, **kw))


def _viewer_json(camera_type, times):
    c2w = _poses(3, seed=9)
    path = {"render_height": 10, "render_width": 14, "camera_path": [
        {"camera_to_world": np.concatenate([p, [[0, 0, 0, 1]]]).reshape(-1).tolist(), "fov": 50.0 + 5 * i}
        for i, p in enumerate(c2w)]}
    if camera_type is not None:
        path["camera_type"] = camera_type
    if times:
        for i, cam in enumerate(path["camera_path"][:2]):  # the third keyframe takes the default 0
            cam["render_time"] = 0.25 * (i + 1)
    return path


@pytest.mark.parametrize("camera_type,times", [(None, False), ("perspective", True), ("fisheye", False),
                                               ("equirectangular", False), ("omnidirectional", True)])
def test_viewer_json_path_matches(camera_type, times):
    path = _viewer_json(camera_type, times)
    _assert_cameras(tpaths.get_path_from_json(path, device=CPU), jpaths.get_path_from_json(path))


# --------------------------------------------------------------------------
# colormaps


def _image(seed=0, c=1, shape=(9, 11)):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, shape + (c,)).astype(np.float32)


@pytest.mark.parametrize("colormap", ["turbo", "viridis", "gray", "default"])
@pytest.mark.parametrize("normalize", [False, True])
def test_colormap_matches(colormap, normalize):
    x = _image()
    got = tcm.apply_colormap(torch.from_numpy(x), colormap, normalize).numpy()
    np.testing.assert_allclose(got, np.asarray(jcm.apply_colormap(jnp.asarray(x), colormap, normalize)), rtol=0,
                               atol=1e-6)
    rgb = _image(c=3)
    np.testing.assert_array_equal(tcm.apply_colormap(torch.from_numpy(rgb)).numpy(), rgb)


@pytest.mark.parametrize("planes", [(None, None), (0.5, 4.0)])
def test_depth_and_boolean_colormaps_match(planes):
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.3, 5.0, (9, 11, 1)).astype(np.float32)
    acc = rng.uniform(0, 1, (9, 11, 1)).astype(np.float32)
    for a in (None, acc):
        got = tcm.apply_depth_colormap(torch.from_numpy(depth), None if a is None else torch.from_numpy(a), *planes)
        ref = jcm.apply_depth_colormap(jnp.asarray(depth), None if a is None else jnp.asarray(a), *planes)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    mask = rng.uniform(size=(9, 11, 1)) > 0.5
    got = tcm.apply_boolean_colormap(torch.from_numpy(mask), (1.0, 0.5, 0.0), (0.0, 0.2, 1.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcm.apply_boolean_colormap(mask, (1.0, 0.5, 0.0),
                                                                                       (0.0, 0.2, 1.0))))


def test_pca_colormap_matches_up_to_the_components_signs():
    """An SVD's signs are free: each channel must equal JAX's c or 1 - c,
    within 1e-5: two LAPACKs' float32 SVDs of the (130, 6) features agree
    to ~10 float32 ulps of the components, which the 1st-99th percentile
    scaling carries into [0, 1] (measured 2.1e-6)."""
    feats = _image(seed=5, c=6, shape=(13, 10))
    got = tcm.apply_pca_colormap(torch.from_numpy(feats)).numpy()
    ref = np.asarray(jcm.apply_pca_colormap(jnp.asarray(feats)))
    for ch in range(3):
        same = np.abs(got[..., ch] - ref[..., ch]).max()
        flipped = np.abs(got[..., ch] - (1 - ref[..., ch])).max()
        assert min(same, flipped) <= 1e-5, (ch, same, flipped)


# --------------------------------------------------------------------------
# marching cubes


def _sphere_volume(res=20):
    lin = np.linspace(-1, 1, res)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return (np.linalg.norm(g, axis=-1) - 0.5).astype(np.float32)


@pytest.mark.parametrize("volume", ["sphere", "noisy"])
def test_marching_cubes_is_exact(volume):
    vol = (_sphere_volume() if volume == "sphere"
           else np.random.default_rng(2).normal(size=(14, 12, 13)).astype(np.float32))
    aabb = ((-1, -0.5, -2), (1, 1.5, 0.5))
    got_v, got_f = tmc.marching_cubes(vol, 0.1, aabb)
    ref_v, ref_f = jmc.marching_cubes(vol, 0.1, aabb)
    assert len(got_f) > 100
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_f, ref_f)
    empty = tmc.marching_cubes(np.ones((4, 4, 4), np.float32), 0.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def _box_sdf_torch(p):
    return torch.abs(p).amax(dim=-1, keepdim=True) - 0.45


def _box_sdf_jax(p):
    return jnp.max(jnp.abs(p), axis=-1, keepdims=True) - 0.45


def test_grid_evaluation_and_multires_are_exact():
    """A field of single-rounding ops (max |x| - 0.45) on the grid, in
    chunks that do not divide it, and the multi-resolution entry."""
    aabb = ((-1, -1, -1), (1, 0.8, 1.2))
    got = tmc.evaluate_grid(_box_sdf_torch, resolution=17, aabb=aabb, chunk=1000, device=CPU)
    ref = jmc.evaluate_grid(_box_sdf_jax, resolution=17, aabb=aabb, chunk=1000)
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(tmc.generate_mesh_with_multires_marching_cubes(_box_sdf_torch, 15, aabb, device=CPU),
                    jmc.generate_mesh_with_multires_marching_cubes(_box_sdf_jax, 15, aabb)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# TSDF fusion, the Poisson solve, the texture bake


def sphere_depth_views(h=48, w=48, focal=48.0, n=8):
    """The depth maps of a radius-0.5 sphere seen from n orbiting cameras
    (tests/exporter/test_mesh_export.py's views): (c2ws, Ks, z-depths, a
    colour per pixel)."""
    views, Ks, depths = [], [], []
    for k in range(n):
        theta = 2 * np.pi * k / n
        pos = 2.0 * np.array([np.cos(theta), np.sin(theta), 0.3])
        fwd = pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 0, 1]), fwd)
        right /= np.linalg.norm(right)
        c2w = np.stack([right, np.cross(fwd, right), fwd, pos], axis=1)
        ys, xs = np.mgrid[0:h, 0:w]
        d_cam = np.stack([(xs + 0.5 - w / 2) / focal, -(ys + 0.5 - h / 2) / focal, -np.ones_like(xs, float)], axis=-1)
        d_world = d_cam @ c2w[:3, :3].T
        d_world_n = d_world / np.linalg.norm(d_world, axis=-1)[..., None]
        b = 2 * (d_world_n @ pos)
        disc = b * b - 4 * (float(pos @ pos) - 0.25)
        t_hit = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, 0.0)
        depths.append(np.where(disc > 0, t_hit * (d_world_n @ -c2w[:3, 2]), 0.0))
        views.append(c2w)
        Ks.append([focal, focal, w / 2, h / 2])
    rgbs = np.random.default_rng(0).uniform(size=(n, h, w, 3))
    return np.stack(views), np.asarray(Ks), np.stack(depths), rgbs


def tsdf_agreement(got, ref):
    """(share of voxels whose observed state (|tsdf| < 0.99) agrees, max
    |difference| where both observe)."""
    obs_g, obs_r = np.abs(got) < 0.99, np.abs(ref) < 0.99
    both = obs_g & obs_r
    return float((obs_g == obs_r).mean()), float(np.abs(got[both] - ref[both]).max()), int(both.sum())


@pytest.mark.parametrize("color", [False, True])
def test_tsdf_fusion_matches(color):
    c2ws, Ks, depths, rgbs = sphere_depth_views()
    rgbs = rgbs if color else None
    box = ((-1, -1, -1), (1, 1, 1))
    got, got_c = ttsdf.tsdf_fusion(c2ws, Ks, depths, rgbs, box, resolution=48, device=CPU)
    ref, ref_c = jtsdf.tsdf_fusion(c2ws, Ks, depths, rgbs, box, resolution=48)
    same_mask, gap, both = tsdf_agreement(got, ref)
    assert both > 1000 and same_mask >= 0.999 and gap <= 1e-5, (same_mask, gap, both)
    if not color:
        assert got_c is None
        return
    # colours: 1e-5 where both observe; elsewhere a voxel whose projection
    # lands within an ulp of a pixel edge may take the neighbouring pixel
    # (the two packages' float32 projections differ in the last bit)
    off = np.abs(got_c - ref_c).max(axis=-1) > 1e-5
    observed = (np.abs(got) < 0.99) & (np.abs(ref) < 0.99)
    assert not off[observed].any() and off.mean() <= 1e-3, (off[observed].sum(), off.mean())


def _sphere_cloud(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * 0.5).astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("aabb", [None, ((-0.8, -0.7, -0.9), (0.7, 0.8, 0.6))])
def test_poisson_matches(aabb):
    pts, nrm = _sphere_cloud()
    chi, iso, box = tpoisson.poisson_reconstruct(pts, nrm, aabb, resolution=32, device=CPU)
    rchi, riso, rbox = jpoisson.poisson_reconstruct(pts, nrm, aabb, resolution=32)
    peak = np.abs(rchi).max()
    assert np.abs(chi - rchi).max() <= 1e-4 * peak
    assert abs(iso - riso) <= 1e-4 * abs(riso)
    for a, b in zip(box, rbox):
        np.testing.assert_array_equal(a, b)
    verts, faces = tpoisson.export_poisson_mesh(pts, nrm, resolution=32, device=CPU)
    r = np.linalg.norm(verts, axis=-1)
    assert len(faces) > 100 and abs(float(np.median(r)) - 0.5) < 0.08


def _analytic_rgb(points):
    return np.stack([points[:, 0] * 0.5 + 0.5, points[:, 1] ** 2, np.abs(points[:, 2])], axis=-1)


def test_texture_bake_and_files_match(tmp_path):
    verts, faces = jmc.marching_cubes(_sphere_volume(10), 0.0)
    tex, uvs = ttex.bake_texture(verts, faces, _analytic_rgb, texels_per_tri=4)
    rtex, ruvs = jtex.bake_texture(verts, faces, _analytic_rgb, texels_per_tri=4)
    assert len(faces) > 50
    np.testing.assert_array_equal(tex, rtex)
    np.testing.assert_array_equal(uvs, ruvs)
    ttex.export_textured_mesh(verts, faces, _analytic_rgb, tmp_path / "port", name="m", texels_per_tri=4)
    jtex.export_textured_mesh(verts, faces, _analytic_rgb, tmp_path / "jax", name="m", texels_per_tri=4)
    for suffix in ("obj", "mtl", "png"):
        assert (tmp_path / "port" / f"m.{suffix}").read_bytes() == (tmp_path / "jax" / f"m.{suffix}").read_bytes()


# --------------------------------------------------------------------------
# PLY files


def test_write_ply_is_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    fields = {"x": rng.normal(size=7).astype(np.float32), "red": rng.integers(0, 255, 7).astype(np.uint8),
              "nx": rng.normal(size=7).astype(np.float32)}
    tply.write_ply(tmp_path / "a" / "t.ply", 7, fields)
    jply.write_ply(tmp_path / "b" / "t.ply", 7, fields)
    assert (tmp_path / "a" / "t.ply").read_bytes() == (tmp_path / "b" / "t.ply").read_bytes()
    xyz_fields = {"x": fields["x"], "y": fields["nx"], "z": fields["x"], "red": fields["red"],
                  "green": fields["red"], "blue": fields["red"]}
    tply.write_ply(tmp_path / "c.ply", 7, xyz_fields)
    xyz, rgb = tply.read_ply(tmp_path / "c.ply")
    np.testing.assert_array_equal(xyz[:, 1], fields["nx"])
    np.testing.assert_array_equal(rgb[:, 2], fields["red"])
    with pytest.raises(ValueError, match="dtype"):
        tply.write_ply(tmp_path / "d.ply", 7, {"x": fields["x"].astype(np.float64)})
    with pytest.raises(ValueError, match="shape"):
        tply.write_ply(tmp_path / "d.ply", 6, fields)


def test_splat_ply_from_converted_params_is_byte_equal(tmp_path):
    """A JAX splat state (SH degree 2, 64 slots with holes) through
    ``utils.convert.splat_state_from_jax``: the port's file equals JAX's."""
    from nerfstudio_tpu.models.splatfacto import SplatfactoModelConfig, init_gaussian_params
    from nerfstudio_tpu.pipelines.splat_pipeline import SplatTrainState, build_splat_optimizers
    from nerfstudio_tpu.scripts.exporter import write_splat_ply as j_write
    from nerfstudio_torch.scripts.exporter import write_splat_ply
    from nerfstudio_torch.utils.convert import splat_state_from_jax

    cfg = SplatfactoModelConfig(max_gaussians=64, num_random=40, random_init=True, sh_degree=2)
    params, aux = init_gaussian_params(cfg)
    rng = np.random.default_rng(0)
    params = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in params.items()}
    aux = aux.replace(alive=jnp.asarray(rng.uniform(size=64) > 0.4))
    tx = build_splat_optimizers(cfg, max_steps=10)
    jstate = jax.device_get(SplatTrainState(params=params, opt_state=tx.init(params), aux=aux,
                                            step=jnp.asarray(0, jnp.int32)))
    tparams, taux, _, _ = splat_state_from_jax(jstate)
    write_splat_ply(tparams, taux.alive, tmp_path / "port.ply")
    j_write(jstate.params, np.asarray(jstate.aux.alive), tmp_path / "jax.ply")
    data = (tmp_path / "port.ply").read_bytes()
    assert data == (tmp_path / "jax.ply").read_bytes()
    assert f"element vertex {int(taux.alive.sum())}\n".encode() in data
    assert b"property float f_rest_23\n" in data and b"property float f_rest_24\n" not in data


# --------------------------------------------------------------------------
# the point cloud of a tiny nerfacto


@pytest.fixture(scope="module")
def nerfacto_pair():
    """(JAX stand-in pipeline and state, the port's) around a tiny nerfacto
    from the same converted params and occupancy grid, K1's table zeroed
    (neutral: its stochastic rounding cannot move a sample), over the
    orbit cameras at HW^2."""
    jmodel, cfg = jax_tiny_nerfacto()
    c2w = orbit_c2w(NUM_IMAGES)
    cam_args = (c2w, HW * 1.2, HW * 1.2, HW / 2, HW / 2, HW, HW)
    res = cfg.occ_grid_resolution
    binary = jnp.asarray(sphere_grid_binary(res))
    jgrid = jocc.init_occupancy_grid(((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), res)
    jgrid = jgrid.replace(binary=binary, binary_rows=jocc._pack_rows(binary, res))
    jcams = JCameras(*cam_args)
    rays = jcams.generate_rays(camera_indices=0).flatten()[:8]
    params = init_params(lambda k: jmodel.init(k, rays, key=None), 1)
    enc = params["params"]["proposal_networks_0"]["mlp_base"]["encoding"]
    enc["hash_table"] = np.zeros_like(enc["hash_table"])
    apply = jax.jit(lambda p, rb, aux: jmodel.apply(p, rb, key=None, model_aux=aux))

    def j_render(p, cams, i, chunk_size=None, aux=None):
        return j_render_camera(lambda rb: apply(p, rb, aux), cams, i, 96)

    jpipe = types.SimpleNamespace(datamanager=types.SimpleNamespace(train_cameras=jcams), render_camera=j_render)
    model = torch_tiny_nerfacto()
    tparams, tgrid = params_from_jax(params, model), occupancy_from_jax(jgrid)

    def t_render(state, cams, i, chunk_size=None):
        return render_camera(model, tparams, cams, i, 96, aux=tgrid)

    tcams = Cameras.create(*cam_args, device=CPU)
    tpipe = types.SimpleNamespace(datamanager=types.SimpleNamespace(train_cameras=tcams), render_camera=t_render)
    return (jpipe, types.SimpleNamespace(params=params, aux=jgrid)), (tpipe, types.SimpleNamespace(aux=tgrid))


@pytest.mark.parametrize("num_points", [10_000, 300])
def test_point_cloud_matches(nerfacto_pair, num_points):
    """The same pixels pass the accumulation mask, so the subsample keeps
    the same points; points and colours within the render test's limits:
    colours 5e-3 mean abs, points (depths) 1e-3 relative on >= 98%,
    normals within 1e-2 on >= 95% (finite differences of the depths)."""
    (jpipe, jstate), (tpipe, tstate) = nerfacto_pair
    got = texu.generate_point_cloud(tpipe, tstate, num_points=num_points, return_normals=True)
    ref = jexu.generate_point_cloud(jpipe, jstate, num_points=num_points, return_normals=True)
    assert got[0].shape == ref[0].shape and len(got[0]) >= min(num_points, 100)
    rel = np.linalg.norm(got[0] - ref[0], axis=-1) / np.linalg.norm(ref[0], axis=-1)
    assert (rel <= 1e-3).mean() >= 0.98, rel.max()
    assert np.abs(got[1] - ref[1]).mean() <= 5e-3
    assert (np.abs(got[2] - ref[2]).max(axis=-1) <= 1e-2).mean() >= 0.95
    points, colors = texu.generate_point_cloud(tpipe, tstate, num_points=num_points)
    np.testing.assert_array_equal(points, got[0])
    np.testing.assert_array_equal(colors, got[1])
