"""The port's COLMAP, instant-ngp, minimal, phototourism, sdfstudio and
specialty parsers (ScanNet, ScanNet++, ARKitScenes, NuScenes, NeRF-OSR,
DyCheck, Sitcoms3D) against the JAX package's, on captures written here
with numpy: COLMAP models in both formats (binary with ``struct``, text
with the reference's writers) at every eval mode, orientation and centring
method, camera model, downscale factor and with and without the 3D
points; tiny captures of each other format (the fixtures of
tests/data/test_specialty_dataparsers.py, with PNGs from the port's
writer). Cameras and intrinsics to 1e-6, the scene box, scale and
transform to 1e-6, filenames, times and metadata exactly
(``assert_outputs_match``); then the SDF dataset's priors and the
semantic dataset over Sitcoms3D's flat keys against JAX's datasets."""

import dataclasses
import json
import struct

import numpy as np
import pytest
import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)

from fixtures import look_at_origin
from test_torch_dataparsers import assert_outputs_match
import nerfstudio_tpu.data.dataparsers.colmap_dataparser as jcolmap
import nerfstudio_tpu.data.dataparsers.colmap_parsing_utils as jcpu
import nerfstudio_tpu.data.dataparsers.extra_dataparsers as jextra
import nerfstudio_tpu.data.dataparsers.specialty_dataparsers as jspec
from nerfstudio_torch.data.dataparsers import colmap_dataparser as tcolmap
from nerfstudio_torch.data.dataparsers import colmap_parsing_utils as tcpu
from nerfstudio_torch.data.dataparsers import extra_dataparsers as textra
from nerfstudio_torch.data.dataparsers import specialty_dataparsers as tspec
from nerfstudio_torch.data.image_io import write_png

MODELS = {  # COLMAP model -> (its id, its parameters for two cameras)
    "SIMPLE_PINHOLE": (0, ([30.0, 12.0, 11.0], [28.0, 12.5, 11.5])),
    "PINHOLE": (1, ([30.0, 31.0, 12.0, 11.0], [29.0, 28.5, 12.5, 11.5])),
    "SIMPLE_RADIAL": (2, ([30.0, 12.0, 11.0, -0.05], [28.0, 12.5, 11.5, 0.02])),
    "RADIAL": (3, ([30.0, 12.0, 11.0, -0.05, 0.01], [28.0, 12.5, 11.5, 0.02, -0.003])),
    "OPENCV": (4, ([30.0, 31.0, 12.0, 11.0, -0.05, 0.01, 1e-3, -2e-3], [29.0, 28.5, 12.5, 11.5, 0.02, 0, 0, 1e-4])),
    "OPENCV_FISHEYE": (5, ([30.0, 31.0, 12.0, 11.0, 0.05, -0.01, 2e-3, -1e-4], [29.0, 28.5, 12.5, 11.5, 0, 0, 0, 0])),
}
N_IMAGES, N_POINTS = 10, 60


def _rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix, w >= 0."""
    w = np.sqrt(max(1.0 + np.trace(r), 1e-12)) / 2
    q = np.array([w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w), (r[1, 0] - r[0, 1]) / (4 * w)])
    return q / np.linalg.norm(q)


def _colmap_model(model: str):
    """(cameras, images, (xyz, rgb, error, track lengths)) of a capture:
    ten views on a tilted, noisy orbit, two cameras of ``model`` taken in
    turns, image ids out of name order, 60 points."""
    rng = np.random.default_rng(7)
    mid, params = MODELS[model]
    cameras = {cid: tcpu.ColmapCamera(id=cid, model=model, width=24 + 2 * k, height=22 + 2 * k,
                                      params=np.array(params[k])) for k, cid in enumerate((3, 8))}
    images = {}
    for i, iid in enumerate(rng.permutation(N_IMAGES) + 1):
        theta = 2 * np.pi * i / N_IMAGES
        pos = np.array([3 * np.cos(theta), 3 * np.sin(theta), 1.0 + 0.3 * np.sin(3 * theta)]) + rng.normal(0, 0.1, 3)
        c2w = look_at_origin(pos)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP's OpenCV
        w2c = np.linalg.inv(c2w)
        images[int(iid)] = tcpu.ColmapImage(id=int(iid), qvec=_rotmat2qvec(w2c[:3, :3]), tvec=w2c[:3, 3],
                                            camera_id=(3, 8)[i % 2], name=f"img_{i:02d}.png", xys=np.zeros((0, 2)),
                                            point3D_ids=np.zeros(0, np.int64))
    points = (rng.normal(0, 0.8, (N_POINTS, 3)), rng.integers(0, 256, (N_POINTS, 3)).astype(np.uint8),
              rng.uniform(0.1, 2.0, N_POINTS), rng.integers(0, 4, N_POINTS))
    return cameras, images, points


def _write_binary(root, cameras, images, points):
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, MODELS[cam.model][0], cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))
    with open(root / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for k, im in enumerate(images.values()):
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", k % 3))  # a few 2D points on some images
            for p in range(k % 3):
                f.write(struct.pack("<ddq", 1.5 * p, 2.5, p))
    xyz, rgb, err, tracks = points
    with open(root / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], *(int(c) for c in rgb[i]), err[i]))
            f.write(struct.pack("<Q", int(tracks[i])) + struct.pack("<" + "ii" * int(tracks[i]),
                                                                     *([1, 0] * int(tracks[i]))))


def _write_text(root, cameras, images, points, writers):
    root.mkdir(parents=True, exist_ok=True)
    writers.write_cameras_text(cameras, root / "cameras.txt")
    writers.write_images_text(images, root / "images.txt")
    xyz, rgb, err, _ = points
    lines = ["# 3D point list"] + [f"{i + 1} {x[0]!r} {x[1]!r} {x[2]!r} {c[0]} {c[1]} {c[2]} {e!r} 1 0"
                                   for i, (x, c, e) in enumerate(zip(xyz.tolist(), rgb.tolist(), err.tolist()))]
    (root / "points3D.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The COLMAP capture of every model, in binary under colmap/sparse/0
    and in text (written by the port's writers) under text/sparse/0, and a
    text copy written by JAX's; a phototourism layout (dense/sparse,
    dense/images) of the OPENCV one."""
    root = tmp_path_factory.mktemp("colmap")
    out = {}
    for model in MODELS:
        cams, ims, pts = _colmap_model(model)
        _write_binary(root / model / "colmap" / "sparse" / "0", cams, ims, pts)
        _write_text(root / model / "text" / "sparse" / "0", cams, ims, pts, tcpu)
        jcams = {k: jcpu.ColmapCamera(**dataclasses.asdict(v)) for k, v in cams.items()}
        jims = {k: jcpu.ColmapImage(**dataclasses.asdict(v)) for k, v in ims.items()}
        _write_text(root / model / "jtext" / "sparse" / "0", jcams, jims, pts, jcpu)
        out[model] = root / model
    photo = root / "photo"
    _write_binary(photo / "dense" / "sparse", *_colmap_model("OPENCV"))
    out["photo"] = photo
    return out


def _pair(jcls, tcls, split, **kw):
    j = jcls(**kw).setup().get_dataparser_outputs(split)
    t = tcls(**kw).setup().get_dataparser_outputs(split)
    assert_outputs_match(j, t)
    for k in ("times", "camera_type"):
        jv = getattr(j.cameras, k)
        if jv is None:
            assert getattr(t.cameras, k) is None or k == "camera_type"
        else:
            np.testing.assert_array_equal(getattr(t.cameras, k).numpy(), np.broadcast_to(
                np.asarray(jv).reshape(-1, 1), getattr(t.cameras, k).shape), err_msg=k)
    assert set(t.metadata) == set(j.metadata)
    for k, jv in j.metadata.items():
        tv = t.metadata[k]
        if isinstance(jv, list):
            assert [str(p) for p in tv] == [str(p) for p in jv], k
        elif jv is None or isinstance(jv, (float, int, str)):
            assert tv == jv, k
        else:
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv), err_msg=k)
    assert (t.mask_filenames is None) == (j.mask_filenames is None)
    if j.mask_filenames is not None:
        assert [str(p) for p in t.mask_filenames] == [str(p) for p in j.mask_filenames]
    return j, t


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("eval_mode", ["fraction", "interval", "all"])
@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_matches_jax(captures, fmt, eval_mode, split):
    """A binary and a text model (the OPENCV capture) at each eval mode and
    split, ``eval_interval`` 3: JAX's outputs, the 3D points (xyz, rgb
    exact, errors) in the poses' frame included."""
    path = "colmap/sparse/0" if fmt == "binary" else "text/sparse/0"
    j, t = _pair(jcolmap.ColmapDataParserConfig, tcolmap.ColmapDataParserConfig, split,
                 data=captures["OPENCV"], colmap_path=path, eval_mode=eval_mode, eval_interval=3)
    assert len(t.metadata["points3D_xyz"]) == N_POINTS and t.cameras.distorted


@pytest.mark.parametrize("orientation, center", [("up", "focus"), ("pca", "poses"), ("vertical", "poses"),
                                                 ("none", "none")])
def test_colmap_orientations_match_jax(captures, orientation, center):
    """Every orientation and centring method, with a scale factor and
    without auto scaling, at both splits."""
    for split in ("train", "val"):
        _pair(jcolmap.ColmapDataParserConfig, tcolmap.ColmapDataParserConfig, split, data=captures["PINHOLE"],
              orientation_method=orientation, center_method=center, scale_factor=0.7,
              auto_scale_poses=orientation != "none")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_colmap_camera_models_match_jax(captures, model):
    """Each camera model the reference reads (intrinsics, distortion, type
    through ``CAMERA_MODEL_TO_TYPE``), at downscale 2 and without the 3D
    points; the text model of JAX's writers reads as the port's writers'."""
    kw = dict(data=captures[model], downscale_factor=2, load_3D_points=False)
    j, t = _pair(jcolmap.ColmapDataParserConfig, tcolmap.ColmapDataParserConfig, "train", **kw)
    assert t.metadata == {} and int(t.cameras.width.max()) == 13
    ours = tcolmap.ColmapDataParserConfig(colmap_path="text/sparse/0", **kw).setup().get_dataparser_outputs("train")
    theirs = tcolmap.ColmapDataParserConfig(colmap_path="jtext/sparse/0", **kw).setup().get_dataparser_outputs("train")
    assert_outputs_match(j, ours)
    assert_outputs_match(j, theirs)


def test_colmap_model_readers_match_jax(captures):
    """``read_model`` of both formats: cameras, images (qvec, tvec, names,
    2D points) and points as JAX's readers give them; an unknown camera
    model raises in both parsers."""
    for path in ("colmap/sparse/0", "text/sparse/0"):
        jc, ji, jp = jcpu.read_model(captures["RADIAL"] / path)
        tc, ti, tp = tcpu.read_model(captures["RADIAL"] / path)
        assert {k: dataclasses.astuple(v)[:4] for k, v in tc.items()} == {k: dataclasses.astuple(v)[:4]
                                                                          for k, v in jc.items()}
        for k in jc:
            np.testing.assert_array_equal(tc[k].params, jc[k].params)
        assert sorted(ti) == sorted(ji)
        for k in ji:
            for f in ("qvec", "tvec", "xys", "point3D_ids"):
                np.testing.assert_array_equal(getattr(ti[k], f), getattr(ji[k], f), err_msg=f)
            assert (ti[k].name, ti[k].camera_id) == (ji[k].name, ji[k].camera_id)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcpu.qvec2rotmat(np.array([0.5, 0.5, -0.5, 0.5])),
                                  jcpu.qvec2rotmat(np.array([0.5, 0.5, -0.5, 0.5])))
    with pytest.raises(FileNotFoundError):
        tcpu.read_model(captures["RADIAL"] / "nowhere")
    with pytest.raises(NotImplementedError, match="FOV"):
        tcolmap._intrinsics("FOV", np.ones(5))


@pytest.mark.parametrize("split", ["train", "val"])
def test_phototourism_matches_jax(captures, split):
    """The phototourism parser (COLMAP under dense/sparse and dense/images,
    a 0.9 fraction split)."""
    _pair(jextra.PhototourismDataParserConfig, textra.PhototourismDataParserConfig, split, data=captures["photo"])


# --------------------------------------------------------------------------
# instant-ngp, minimal, sdfstudio


def _png(path, hw=8, channels=3):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.random.default_rng(0).integers(0, 255, (hw, hw, channels), dtype=np.uint8))


def _pose(i, n=4):
    theta = 2 * np.pi * i / n
    c2w = np.eye(4)
    c2w[:3, 3] = [2 * np.cos(theta), 2 * np.sin(theta), 1.0]
    return c2w


@pytest.mark.parametrize("intrinsics", ["focal", "angles"])
def test_instant_ngp_matches_jax(tmp_path, intrinsics):
    """transforms.json with focal lengths and k1, k2, p1, p2, or with field
    of view angles; ``aabb_scale``; file paths with and without suffix."""
    meta = {"w": 20, "h": 16, "aabb_scale": 4, "k1": -0.02, "p2": 1e-3,
            "frames": [{"file_path": f"images/f{i}" + (".png" if i % 2 else ""),
                        "transform_matrix": (look_at_origin(np.array([2.0, i - 1.5, 1.0])) * 0.8).tolist()}
                       for i in range(4)]}
    meta.update({"fl_x": 30.0, "fl_y": 29.0, "cx": 9.5} if intrinsics == "focal" else
                {"camera_angle_x": 0.9, "camera_angle_y": 0.75})
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    _pair(jextra.InstantNGPDataParserConfig, textra.InstantNGPDataParserConfig, "train", data=tmp_path)


def test_minimal_matches_jax(tmp_path):
    """A ``{split}.npz`` dump with and without an aabb."""
    rng = np.random.default_rng(3)
    n = 3
    arrays = dict(camera_to_worlds=rng.normal(size=(n, 3, 4)), fx=rng.uniform(20, 30, n), fy=rng.uniform(20, 30, n),
                  cx=np.full(n, 8.0), cy=np.full(n, 7.0), width=np.full(n, 16), height=np.full(n, 14),
                  image_filenames=np.array([f"im{i}.png" for i in range(n)], dtype=object))
    np.savez(tmp_path / "train.npz", **arrays, aabb=np.array([[-2, -2, -1], [2, 2, 1]], np.float32))
    np.savez(tmp_path / "val.npz", **arrays)
    for split in ("train", "val"):
        _pair(jextra.MinimalDataParserConfig, textra.MinimalDataParserConfig, split, data=tmp_path)


def _sdfstudio(root, n=3, hw=6):
    rng = np.random.default_rng(4)
    frames = []
    for i in range(n):
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 20.0 + i, 21.0, 3.0, 2.5
        frames.append({"rgb_path": f"rgb/{i}.png", "camtoworld": _pose(i, n).tolist(), "intrinsics": K.tolist(),
                       "mono_depth_path": f"depth/{i}.npy", "mono_normal_path": f"normal/{i}.npy"})
        (root / "depth").mkdir(parents=True, exist_ok=True)
        (root / "normal").mkdir(parents=True, exist_ok=True)
        np.save(root / "depth" / f"{i}.npy", rng.uniform(0.5, 3, (hw, hw)).astype(np.float32))
        np.save(root / "normal" / f"{i}.npy", rng.uniform(0, 1, (hw, hw, 3)).astype(np.float32))
    (root / "meta_data.json").write_text(json.dumps({"height": hw, "width": hw, "frames": frames,
                                                     "scene_box": {"aabb": [[-1, -1, -0.5], [1, 1, 1.5]]}}))
    return root


@pytest.mark.parametrize("prior", [False, True])
def test_sdfstudio_and_sdf_dataset_match_jax(tmp_path, prior):
    """The sdfstudio parser with and without the monocular priors, and the
    SDF dataset's depth (H, W, 1) and world-space normals against JAX's
    (float32 products of the same rotation: 1e-6)."""
    from nerfstudio_tpu.data.datasets import SDFDataset as JSDFDataset
    from nerfstudio_torch.data.datasets import SDFDataset

    root = _sdfstudio(tmp_path)
    for split in ("train", "val"):
        j, t = _pair(jextra.SDFStudioDataParserConfig, textra.SDFStudioDataParserConfig, split, data=root,
                     include_mono_prior=prior)
    jd, td = JSDFDataset(j), SDFDataset(t)
    for i in range(len(td)):
        want, got = jd.get_metadata(i), td.get_metadata(i)
        assert set(got) == set(want) == ({"depth_image", "normal_image"} if prior else set())
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# the specialty parsers (tests/data/test_specialty_dataparsers.py's captures)


def _scannet(root):
    (root / "pose").mkdir(parents=True)
    for i in range(4):
        _png(root / "color" / f"{i}.jpg")
        _png(root / "depth" / f"{i}.png")
        np.savetxt(root / "pose" / f"{i}.txt", _pose(i))
    (root / "intrinsic").mkdir()
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 100.0
    K[0, 2] = K[1, 2] = 4.0
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", K)
    return dict(data=root, train_split_fraction=0.75)


def _scannetpp(root):
    frames = []
    for i in range(4):
        _png(root / "dslr" / "resized_images" / f"f{i}.jpg")
        frames.append({"file_path": f"f{i}.jpg", "transform_matrix": _pose(i).tolist(), "mask_path": f"m{i}.png"})
    meta = {"fl_x": 100.0, "fl_y": 100.0, "cx": 4.0, "cy": 4.0, "w": 8, "h": 8, "k1": 0.01, "k2": 0.0, "k3": 0.0,
            "k4": 0.0, "p1": 0.0, "p2": 0.0, "camera_model": "OPENCV", "frames": frames[:3], "test_frames": frames[3:]}
    (root / "dslr" / "nerfstudio").mkdir(parents=True)
    (root / "dslr" / "nerfstudio" / "transforms.json").write_text(json.dumps(meta))
    return dict(data=root)


def _arkitscenes(root):
    vid = root.name
    fdir = root / f"{vid}_frames"
    lines = []
    for i in range(4):
        ts = 1000.0 + i * 0.1
        _png(fdir / "lowres_wide" / f"{vid}_{ts:.3f}.png")
        _png(fdir / "lowres_depth" / f"{vid}_{ts:.3f}.png")
        (fdir / "lowres_wide_intrinsics").mkdir(parents=True, exist_ok=True)
        np.savetxt(fdir / "lowres_wide_intrinsics" / f"{vid}_{ts:.3f}.pincam",
                   np.array([[8, 8, 100.0, 100.0, 4.0, 4.0]]))
        t = np.array([np.cos(i), np.sin(i), 1.0])
        lines.append(f"{ts + (0.001 if i == 2 else 0.0):.3f} 0.0 0.0 {0.1 * i} {t[0]} {t[1]} {t[2]}")
    (fdir / "lowres_wide.traj").write_text("\n".join(lines))
    return dict(data=root, train_split_fraction=0.75)


def _nuscenes(root):
    tdir = root / "v1.0-mini"
    tdir.mkdir()
    sample_data = [{"token": f"sd{i}", "sample_token": "sa0", "ego_pose_token": f"e{i % 2}",
                    "calibrated_sensor_token": "c0", "is_key_frame": i != 2, "timestamp": 10 - i,
                    "filename": f"samples/CAM_{cam}/img{i}.jpg"}
                   for i, cam in enumerate(("FRONT", "FRONT", "FRONT", "BACK", "FRONT"))]
    tables = {
        "scene": [{"token": "s0", "name": "scene-0001"}],
        "sample": [{"token": "sa0", "scene_token": "s0"}],
        "ego_pose": [{"token": "e0", "rotation": [1, 0, 0, 0], "translation": [10.0, 5.0, 0.0]},
                     {"token": "e1", "rotation": [0.9, 0, 0, 0.1], "translation": [12.0, 5.5, 0.1]}],
        "calibrated_sensor": [{"token": "c0", "rotation": [0.5, -0.5, 0.5, -0.5], "translation": [1.0, 0.0, 1.5],
                               "camera_intrinsic": [[1266.0, 0, 800.0], [0, 1266.0, 450.0], [0, 0, 1]]}],
        "sample_data": sample_data,
    }
    for name, rows in tables.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    return dict(data="scene-0001", data_dir=root, train_split_fraction=0.5, cameras=("FRONT", "BACK"))


def _nerfosr(root):
    for split, n in (("train", 3), ("val", 2)):
        base = root / "stjacob" / "final" / split
        (base / "pose").mkdir(parents=True)
        (base / "intrinsics").mkdir(parents=True)
        for i in range(n):
            _png(base / "rgb" / f"im{i}.png")
            _png(base / "mask" / f"im{i}.png")
            np.savetxt(base / "pose" / f"im{i}.txt", _pose(i + 5 * (split == "val")).reshape(1, -1))
            K = np.eye(4)
            K[0, 0] = K[1, 1] = 100.0 + i
            K[0, 2], K[1, 2] = 4.0, 3.5
            np.savetxt(base / "intrinsics" / f"im{i}.txt", K)
    return dict(data=root, scene="stjacob", use_masks=True)


def _dycheck(root):
    (root / "scene.json").write_text(json.dumps({"center": [0.1, 0, 0], "scale": 0.5, "near": 0.1, "far": 10.0}))
    (root / "metadata.json").write_text(json.dumps({"num_frames": 3}))
    (root / "splits").mkdir()
    (root / "splits" / "train.json").write_text(json.dumps({"frame_names": [f"0_{i:05d}" for i in range(3)],
                                                            "time_ids": [0, 1, 2]}))
    (root / "camera").mkdir()
    (root / "processed_depth" / "2x").mkdir(parents=True)
    for i in range(3):
        (root / "camera" / f"0_{i:05d}.json").write_text(json.dumps(
            {"orientation": np.eye(3).tolist(), "position": [0.0, 0.0, float(i)], "focal_length": 100.0,
             "principal_point": [4.0, 4.0], "image_size": [8, 8], "pixel_aspect_ratio": 1.01}))
        _png(root / "rgb" / "2x" / f"0_{i:05d}.png", hw=4)
        np.save(root / "processed_depth" / "2x" / f"0_{i:05d}.npy", np.ones((4, 4), np.float32))
    return dict(data=root, downscale_factor=2)


def _sitcoms3d(root):
    frames = []
    for i in range(3):
        _png(root / "images_4" / f"im{i}.png")
        _png(root / "segmentations_4" / "thing" / f"im{i}.png", channels=1)
        K = [[400.0, 0, 100.0], [0, 400.0, 80.0], [0, 0, 1]]
        frames.append({"image_name": f"im{i}.png", "intrinsics": K, "camtoworld": _pose(i).tolist()})
    (root / "cameras.json").write_text(json.dumps({"frames": frames, "bbox": [[-1, -1, -0.5], [1, 2, 1]]}))
    (root / "panoptic_classes.json").write_text(json.dumps({"thing": ["person", "chair", "table"]}))
    return dict(data=root)


SPECIALTY = {"ScanNet": _scannet, "ScanNetpp": _scannetpp, "ARKitScenes": _arkitscenes, "NuScenes": _nuscenes,
             "NeRFOSR": _nerfosr, "Dycheck": _dycheck, "Sitcoms3D": _sitcoms3d}


@pytest.mark.parametrize("name", sorted(SPECIALTY))
def test_specialty_parser_matches_jax(tmp_path, name):
    """Each specialty parser on its tiny capture at both splits (the
    split the parser takes for "val"): cameras, filenames, times
    (DyCheck's), masks (ScanNet++'s, NeRF-OSR's), depth files (ScanNet's,
    ARKitScenes', DyCheck's) and Sitcoms3D's label files and classes."""
    (tmp_path / "capture").mkdir()
    kw = SPECIALTY[name](tmp_path / "capture")
    jcls, tcls = (getattr(m, f"{name}DataParserConfig") for m in (jspec, tspec))
    for split in ("train", "val"):
        j, t = _pair(jcls, tcls, split, **kw)
    assert (t.cameras.times is not None) == (name == "Dycheck")


def test_semantic_dataset_reads_sitcoms3d_labels_as_jax(tmp_path):
    """semantic-nerfw's dataset over the Sitcoms3D parser's flat keys: the
    classes, the colours drawn as JAX draws them, and each frame's labels
    (the label PNG's grey values) equal JAX's."""
    from nerfstudio_tpu.data.datasets import SemanticDataset as JSemanticDataset
    from nerfstudio_torch.data.datasets import SemanticDataset

    kw = _sitcoms3d(tmp_path / "capture")
    j = jspec.Sitcoms3DDataParserConfig(**kw).setup().get_dataparser_outputs("train")
    t = tspec.Sitcoms3DDataParserConfig(**kw).setup().get_dataparser_outputs("train")
    jd, td = JSemanticDataset(j), SemanticDataset(t)
    assert td.semantics.classes == jd.semantics.classes == ["person", "chair", "table"]
    np.testing.assert_array_equal(td.semantics.colors, jd.semantics.colors)
    for i in range(len(td)):
        got, want = td.get_metadata(i)["semantics"], jd.get_metadata(i)["semantics"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_factory_builds_the_sdf_dataset(tmp_path):
    """``dataset="sdf"`` (refused before) builds ``SDFDataset`` splits
    through the factory from an sdfstudio capture, and the datamanager
    stacks the depth priors as JAX's does (``depth_image``); nothing reads
    the normals."""
    from nerfstudio_torch.configs.method_configs import get_method
    from nerfstudio_torch.data.datamanagers import DeviceCacheDataManager
    from nerfstudio_torch.data.datasets import SDFDataset
    from nerfstudio_torch.pipelines.factory import build_datasets

    root = _sdfstudio(tmp_path)
    for i in range(3):
        _png(root / "rgb" / f"{i}.png", hw=6)
    config = get_method("neus-facto")
    config.dataset = "sdf"
    config.dataparser = textra.SDFStudioDataParserConfig(include_mono_prior=True)
    config.data = root
    train, held, outputs = build_datasets(config)
    assert type(train) is type(held) is SDFDataset and len(train) == 3
    dm = DeviceCacheDataManager.from_datasets(config.datamanager, train, held, device="cpu")
    assert dm.train_depths.shape == (3, 6, 6, 1)
    np.testing.assert_array_equal(dm.train_depths[1].numpy(), train.get_metadata(1)["depth_image"])
    _, batch = dm.sample_train_batch(num_rays=16)
    assert batch["depth_image"].shape == (16, 1) and "normal_image" not in batch
