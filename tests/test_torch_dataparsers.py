"""The port's dataparsers against the JAX package's on the same scenes:
the nerfstudio parser (the fixture capture, the same capture with
per-frame intrinsics and a "vertical"/"focus" orientation, and the synthetic
tool's scene with its seed points) at every split and eval mode, and the
Blender parser (the fixture and the tool's scene) at its three splits.
Cameras and intrinsics to 1e-6, the scene box, scale and transform to
1e-6, split filenames and seed points exactly."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_port import make_synthetic_scene
from fixtures import make_blender_fixture, make_nerfstudio_fixture
from nerfstudio_tpu.data.dataparsers.blender_dataparser import BlenderDataParserConfig as JBlender
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_torch.data.dataparsers import registry
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig

EVAL_MODES = ("fraction", "interval", "all")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    ns = make_nerfstudio_fixture(root / "ns", n=10, hw=24)
    # the same capture with per-frame intrinsics and sizes, no global ones
    per_frame = root / "ns_per_frame"
    per_frame.mkdir()
    (per_frame / "images").symlink_to(ns / "images")
    meta = json.loads((ns / "transforms.json").read_text())
    for i, fr in enumerate(meta["frames"]):
        fr.update(fl_x=40.0 + i, fl_y=41.0 + i, cx=12.0, cy=11.5 + 0.1 * i, w=24, h=24)
    for k in ("fl_x", "fl_y", "cx", "cy", "w", "h", "k1", "k2", "p1", "p2"):
        meta.pop(k)
    (per_frame / "transforms.json").write_text(json.dumps(meta))
    return {"ns": ns, "ns_per_frame": per_frame, "blender": make_blender_fixture(root / "blender", n_train=5, n_val=2),
            "synthetic": make_synthetic_scene(root / "synthetic")}


def assert_outputs_match(j, t):
    jc, tc = j.cameras, t.cameras
    np.testing.assert_allclose(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds).reshape(-1, 3, 4),
                               rtol=0, atol=1e-6)
    for f in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)).reshape(-1, 1), rtol=1e-6)
    for f in ("width", "height"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.broadcast_to(np.asarray(getattr(jc, f)).reshape(-1, 1), getattr(tc, f).shape))
    if jc.distortion_params is None:
        assert tc.distortion_params is None
    else:
        np.testing.assert_array_equal(tc.distortion_params.numpy(), np.asarray(jc.distortion_params))
    assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
    np.testing.assert_allclose(t.scene_box.aabb.numpy(), np.asarray(j.scene_box.aabb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.dataparser_scale, j.dataparser_scale, rtol=1e-6)
    np.testing.assert_allclose(t.dataparser_transform, np.asarray(j.dataparser_transform), rtol=0, atol=1e-6)
    if j.alpha_color is None:
        assert t.alpha_color is None
    else:
        np.testing.assert_array_equal(t.alpha_color.numpy(), np.asarray(j.alpha_color))
    for k in ("points3D_xyz", "points3D_rgb"):
        if j.metadata.get(k) is None:
            assert t.metadata.get(k) is None, k
        else:
            np.testing.assert_array_equal(t.metadata[k].numpy(), np.asarray(j.metadata[k]), err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("eval_mode", EVAL_MODES)
@pytest.mark.parametrize("scene", ["ns", "ns_per_frame", "synthetic"])
def test_nerfstudio_parser_matches_jax(scenes, scene, eval_mode, split):
    kw = dict(data=scenes[scene], eval_mode=eval_mode, eval_interval=3, load_3D_points=True)
    if scene == "ns_per_frame":
        kw.update(orientation_method="vertical", center_method="focus", scale_factor=0.8)
    j = JNerfstudio(**kw).setup().get_dataparser_outputs(split)
    t = NerfstudioDataParserConfig(**kw).setup().get_dataparser_outputs(split)
    assert_outputs_match(j, t)
    assert t.cameras.camera_to_worlds.dtype == torch.float32 and t.cameras.camera_to_worlds.device.type == "cpu"


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("scene", ["blender", "synthetic"])
def test_blender_parser_matches_jax(scenes, scene, split):
    j = JBlender(data=scenes[scene]).setup().get_dataparser_outputs(split)
    t = BlenderDataParserConfig(data=scenes[scene]).setup().get_dataparser_outputs(split)
    assert_outputs_match(j, t)


def test_pca_orientation_takes_4x4_poses(scenes):
    """The "pca" orientation on transforms.json's 4x4 matrices: the port
    orients the top three rows (the reference stacks a fifth row under
    them and raises), giving orthonormal rotations."""
    kw = dict(data=scenes["ns"], orientation_method="pca")
    with pytest.raises(ValueError, match="matmul"):
        JNerfstudio(**kw).setup().get_dataparser_outputs("train")
    c2w = NerfstudioDataParserConfig(**kw).setup().get_dataparser_outputs("train").cameras.camera_to_worlds.numpy()
    rot = c2w[:, :, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape), atol=1e-5)


def test_split_fraction_of_the_gate_scene(scenes):
    """The gate's split (``train_split_fraction=0.9``) over the tool's 10
    frames (8 train, 2 test): 9 train, 1 held out, disjoint (at the tool's
    defaults, 90 frames: 81 and 9)."""
    kw = dict(data=scenes["synthetic"], train_split_fraction=0.9, downscale_factor=1)
    train = NerfstudioDataParserConfig(**kw).setup().get_dataparser_outputs("train").image_filenames
    held = NerfstudioDataParserConfig(**kw).setup().get_dataparser_outputs("val").image_filenames
    assert len(train) == 9 and len(held) == 1 and not set(train) & set(held)


def test_registry_ports_two_parsers_and_names_the_rest():
    """Every parser of the reference's registry is ported: each name (and
    each short alias without ``-data``) gives a fresh config of the port's
    class of the same name, with the same fields and defaults (JAX's
    ``_target`` class aside); an unknown name raises."""
    from nerfstudio_tpu.data.dataparsers.registry import dataparser_registry

    assert type(registry.get_dataparser_config("nerfstudio-data")) is NerfstudioDataParserConfig
    assert type(registry.get_dataparser_config("blender")) is BlenderDataParserConfig
    reference = dataparser_registry()
    assert set(registry.DATAPARSERS) == {k for k in reference if k.endswith("-data") or k in ("colmap",
                                                                                             "minimal-parser")}
    for name, jcls in reference.items():
        cfg = registry.get_dataparser_config(name)
        assert type(cfg).__name__ == jcls.__name__, name
        jcfg = jcls()
        assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} == \
            {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "_target"}, name
    with pytest.raises(KeyError):
        registry.get_dataparser_config("no-such-parser")


def test_cameras_take_zero_distortion_and_refuse_any_other():
    """All-zero distortion parameters (a frame without distortion keys) are
    the identity and kept, and the cameras read as undistorted; a non-zero
    entry, which the port once refused, is kept too and marks them
    distorted (ray generation then runs the Newton solve)."""
    from nerfstudio_torch.cameras.cameras import Cameras

    c2w = np.tile(np.eye(4, dtype=np.float32)[:3], (2, 1, 1))
    cams = Cameras.create(c2w, 10.0, 10.0, 4.0, 4.0, 8, 8, distortion_params=np.zeros((2, 6)), device="cpu")
    assert torch.equal(cams.distortion_params, torch.zeros(2, 6)) and not cams.distorted
    d = np.zeros((2, 6))
    d[1, 4] = 1e-3
    cams = Cameras.create(c2w, 10.0, 10.0, 4.0, 4.0, 8, 8, distortion_params=d, device="cpu")
    assert cams.distorted and torch.equal(cams.distortion_params, torch.tensor(d, dtype=torch.float32))


CAMERA_CASES = {
    "fisheye": dict(camera_model="OPENCV_FISHEYE", k1=0.05, k2=-0.01, k3=0.002, k4=-1e-4),
    "equirectangular": dict(camera_model="EQUIRECTANGULAR"),
    "fisheye624": dict(camera_model="FISHEYE624", distortion_params=[0.03, -0.01, 0.002, -1e-4, 1e-5, -1e-6, 1e-3,
                                                                        -5e-4, 2e-4, -1e-4, 1e-4, -5e-5]),
    "opencv_per_frame": dict(camera_model="OPENCV"),
    "unknown_model": dict(camera_model="THIN_PRISM_FISHEYE"),
}


@pytest.mark.parametrize("case", list(CAMERA_CASES))
def test_camera_models_and_masks_as_jax(scenes, tmp_path, case):
    """The fixture capture rewritten to another camera model (global
    distortion, a 12-value list for Fisheye624, per-frame OpenCV terms; a
    name the reference does not know is perspective), each frame with a
    ``mask_path``: the port's cameras (types and arrays) and mask filenames
    equal the JAX parser's at both splits; then with a ``depth_file_path``
    and a ``semantic_path`` on every frame too, the depth files, their unit
    scale and the semantic labels' files, classes and colours as well."""
    root = tmp_path / case
    root.mkdir()
    (root / "images").symlink_to(scenes["ns"] / "images")
    meta = json.loads((scenes["ns"] / "transforms.json").read_text())
    for k in ("k1", "k2", "p1", "p2"):
        meta.pop(k)
    meta.update(CAMERA_CASES[case])
    for i, fr in enumerate(meta["frames"]):
        fr["mask_path"] = f"masks/m_{i}.png"
        if case == "opencv_per_frame":
            fr.update(k1=-0.1 * i / 10, k2=0.01 * i, p1=1e-4 * i)
    (root / "transforms.json").write_text(json.dumps(meta))
    for split in ("train", "val"):
        j = JNerfstudio(data=root).setup().get_dataparser_outputs(split)
        t = NerfstudioDataParserConfig(data=root).setup().get_dataparser_outputs(split)
        assert_outputs_match(j, t)
        np.testing.assert_array_equal(t.cameras.camera_type.numpy(),
                                      np.broadcast_to(np.asarray(j.cameras.camera_type).reshape(-1, 1),
                                                      t.cameras.camera_type.shape))
        assert [str(p) for p in t.mask_filenames] == [str(p) for p in j.mask_filenames]
    # the same frames with a depth file and a label image each: their
    # filenames, unit scale and classes parse as JAX's beside the masks
    for i, fr in enumerate(meta["frames"]):
        fr.update(depth_file_path=f"depths/d_{i}.png", semantic_path=f"labels/s_{i}.png")
    (root / "transforms.json").write_text(json.dumps(meta))
    for split in ("train", "val"):
        j = JNerfstudio(data=root).setup().get_dataparser_outputs(split)
        t = NerfstudioDataParserConfig(data=root).setup().get_dataparser_outputs(split)
        assert_outputs_match(j, t)
        assert [str(p) for p in t.metadata["depth_filenames"]] == [str(p) for p in j.metadata["depth_filenames"]]
        assert t.metadata["depth_unit_scale_factor"] == j.metadata["depth_unit_scale_factor"]
        ts, js = t.metadata["semantics"], j.metadata["semantics"]
        assert [str(p) for p in ts.filenames] == [str(p) for p in js.filenames] and ts.classes == js.classes
        np.testing.assert_array_equal(ts.colors, js.colors)
        assert [str(p) for p in t.mask_filenames] == [str(p) for p in j.mask_filenames]


@pytest.mark.parametrize("scene", ["synthetic", "blender"])
def test_jax_outputs_convert_to_the_ports(scenes, scene):
    """``utils.convert.dataparser_outputs_from_jax`` of the JAX parser's
    outputs equals the port's own parse."""
    from nerfstudio_torch.utils.convert import dataparser_outputs_from_jax

    if scene == "blender":
        j = JBlender(data=scenes[scene]).setup().get_dataparser_outputs("val")
    else:
        j = JNerfstudio(data=scenes[scene], load_3D_points=True).setup().get_dataparser_outputs("train")
    assert_outputs_match(j, dataparser_outputs_from_jax(j))
