"""The port's capture ingestion and the rest of the host modules on the CPU,
against the JAX package: every vendor converter's and COLMAP's
transforms.json byte-equal to JAX's; the equirectangular crops at 1e-6;
the Pillow bicubic resampler ported in numpy against Pillow itself (every
pixel, RGB and grey, RGBA and LA premultiplied, factors 2, 4, 8, odd
sizes); ``copy_images``' pyramids and ``scripts/process_data.py``'s
subcommands against JAX's (the SfM step refusing without the colmap binary
after the pyramids are written, as JAX's does); the binaries' and hloc's
refusals; method and dataparser plugins through the environment, the
external catalogue's install text; the completions; the profiler and the
decorators."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)
import nerfstudio_tpu.process_data.colmap_utils as jcolmap
import nerfstudio_tpu.process_data.converters as jconv
import nerfstudio_tpu.process_data.equirect_utils as jeq
import nerfstudio_tpu.process_data.process_data_utils as jpdu
import nerfstudio_tpu.scripts.process_data as jscript
from nerfstudio_tpu.data.dataparsers import colmap_parsing_utils as jcpu
from nerfstudio_torch.data.image_io import read_image as read_png
from nerfstudio_torch.process_data import colmap_utils as tcolmap
from nerfstudio_torch.process_data import converters as tconv
from nerfstudio_torch.process_data import equirect_utils as teq
from nerfstudio_torch.process_data import hloc_utils as thloc
from nerfstudio_torch.process_data import process_data_utils as tpdu
from nerfstudio_torch.scripts import process_data as tscript

SEED = 5


def write_photo(path: Path, rng, hw=(13, 21), mode="RGB"):
    shape = hw + ({"RGB": (3,), "L": (), "RGBA": (4,)}[mode])
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)


def same_files(a: Path, b: Path, name: str = "transforms.json") -> None:
    assert (b / name).read_bytes() == (a / name).read_bytes()


# ---------------------------------------------------------------------------
# converters


def make_colmap_model(model_dir: Path, rng, n=5, points=40):
    """A COLMAP text model written with JAX's writers: one OPENCV camera,
    ``n`` images on a ring looking at the origin, ``points`` coloured
    points."""
    from nerfstudio_tpu.cameras.camera_utils import quaternion_from_matrix

    model_dir.mkdir(parents=True, exist_ok=True)
    cams = {1: jcpu.ColmapCamera(id=1, model="OPENCV", width=24, height=18,
                                 params=np.array([20.5, 21.0, 12.2, 8.9, 0.01, -0.002, 0.001, 0.0005]))}
    images = {}
    for i in range(1, n + 1):
        theta = 2 * np.pi * i / n
        pos = np.array([2 * np.cos(theta), 2 * np.sin(theta), 0.7]) + rng.normal(0, 0.05, 3)
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 0, -1]), fwd)
        right /= np.linalg.norm(right)
        r_c2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        m = np.eye(4)
        m[:3, :3] = r_c2w.T
        images[i] = jcpu.ColmapImage(id=i, qvec=quaternion_from_matrix(m), tvec=-r_c2w.T @ pos, camera_id=1,
                                     name=f"frame_{i:05d}.png", xys=np.zeros((0, 2)),
                                     point3D_ids=np.zeros((0,), np.int64))
    jcpu.write_cameras_text(cams, model_dir / "cameras.txt")
    jcpu.write_images_text(images, model_dir / "images.txt")
    xyz = rng.normal(size=(points, 3))
    rgb = rng.integers(0, 256, (points, 3))
    lines = ["# 3D point list"] + [f"{i + 1} {x:.9f} {y:.9f} {z:.9f} {r} {g} {b} 0.5"
                                   for i, ((x, y, z), (r, g, b)) in enumerate(zip(xyz, rgb))]
    (model_dir / "points3D.txt").write_text("\n".join(lines) + "\n")


def test_colmap_to_json_matches_jax(tmp_path):
    """transforms.json and the seed points' PLY byte-equal to JAX's, and the
    frame count."""
    model = tmp_path / "sparse" / "0"
    make_colmap_model(model, np.random.default_rng(SEED))
    assert tcolmap.colmap_to_json(model, tmp_path / "t") == jcolmap.colmap_to_json(model, tmp_path / "j") == 5
    same_files(tmp_path / "j", tmp_path / "t")
    same_files(tmp_path / "j", tmp_path / "t", "sparse_pc.ply")


def test_polycam_matches_jax(tmp_path):
    rng = np.random.default_rng(SEED)
    kf = tmp_path / "cap" / "keyframes"
    for i in range(4):
        (kf / "cameras").mkdir(parents=True, exist_ok=True)
        cam = {"fx": 100.0 + i, "fy": 101.0, "cx": 4.5, "cy": 3.5, "width": 9, "height": 7,
               "blur_score": [100.0, 10.0, 50.0, 30.0][i]}
        for r in range(3):
            for c in range(4):
                cam[f"t_{r}{c}"] = float(rng.normal())
        (kf / "cameras" / f"{i}.json").write_text(json.dumps(cam))
        write_photo(kf / "images" / (f"{i}.jpg" if i % 2 else f"{i}.png"), rng)
    assert tconv.polycam_to_json(tmp_path / "cap", tmp_path / "t") == jconv.polycam_to_json(tmp_path / "cap",
                                                                                              tmp_path / "j") == 3
    same_files(tmp_path / "j", tmp_path / "t")


def test_record3d_matches_jax(tmp_path):
    rng = np.random.default_rng(SEED)
    K = np.array([[100.0, 0, 0], [0, 101.0, 0], [4.0, 4.5, 1]])
    poses = [list(rng.normal(size=4)) + list(rng.normal(size=3)) for _ in range(3)]
    (tmp_path / "metadata.json").write_text(json.dumps({"K": K.reshape(-1).tolist(), "poses": poses, "w": 8,
                                                        "h": 9}))
    for i in range(4):
        write_photo(tmp_path / "rgbd" / f"{i}.jpg", rng)
    assert tconv.record3d_to_json(tmp_path, tmp_path / "t") == jconv.record3d_to_json(tmp_path, tmp_path / "j") == 3
    same_files(tmp_path / "j", tmp_path / "t")


def test_metashape_matches_jax(tmp_path):
    xml = """<document><chunk>
      <sensors><sensor id="0"><calibration>
        <resolution width="8" height="6"/><f>100.5</f><cx>0.5</cx><cy>-0.25</cy>
        <k1>0.01</k1><p2>0.002</p2></calibration></sensor><sensor id="1"/></sensors>
      <cameras>
        <camera sensor_id="0" label="a.jpg"><transform>1 0 0 0 0 0.8 -0.6 0 0 0.6 0.8 2 0 0 0 1</transform></camera>
        <camera sensor_id="0" label="b.jpg"><transform>0 -1 0 1 1 0 0 0 0 0 1 2 0 0 0 1</transform></camera>
        <camera sensor_id="1" label="c.jpg"><transform>1 0 0 1 0 1 0 0 0 0 1 2 0 0 0 1</transform></camera>
        <camera sensor_id="0" label="d.jpg"/>
      </cameras></chunk></document>"""
    (tmp_path / "cameras.xml").write_text(xml)
    assert tconv.metashape_to_json(tmp_path / "cameras.xml", "images", tmp_path / "t") == \
        jconv.metashape_to_json(tmp_path / "cameras.xml", "images", tmp_path / "j") == 2
    same_files(tmp_path / "j", tmp_path / "t")


def test_realitycapture_matches_jax(tmp_path):
    csv = "#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
    csv += "a.jpg,0.5,-1,1,10,20,-5,36.0,0.01,-0.02,0.1,0,0,0,0,0\n"
    csv += "b.jpg,1,0,1.5,90,-10,3,50.0,0,0,0,0.05,0,0,0,0\n"
    (tmp_path / "poses.csv").write_text(csv)
    assert tconv.realitycapture_to_json(tmp_path / "poses.csv", "images", tmp_path / "t") == \
        jconv.realitycapture_to_json(tmp_path / "poses.csv", "images", tmp_path / "j") == 2
    same_files(tmp_path / "j", tmp_path / "t")


def test_odm_matches_jax(tmp_path):
    recon = [{"cameras": {"cam0": {"focal": 0.9, "width": 8, "height": 6, "k1": 0.01, "k2": 0.0, "c_x": 0.02},
                          "cam1": {"focal_x": 0.7, "width": 10, "height": 10}},
              "shots": {"a.jpg": {"camera": "cam0", "rotation": [0, 0, 0], "translation": [0, 0, -2]},
                        "b.jpg": {"camera": "cam0", "rotation": [0.1, -0.2, 0.3], "translation": [1, 0, -2]},
                        "c.jpg": {"camera": "cam1", "rotation": [1e-13, 0, 0], "translation": [0, 1, -2]}}}]
    (tmp_path / "reconstruction.json").write_text(json.dumps(recon))
    assert tconv.odm_to_json(tmp_path / "reconstruction.json", "images", tmp_path / "t") == \
        jconv.odm_to_json(tmp_path / "reconstruction.json", "images", tmp_path / "j") == 3
    same_files(tmp_path / "j", tmp_path / "t")


# ---------------------------------------------------------------------------
# images: the resampler, pyramids, equirectangular crops


@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
def test_bicubic_downscale_gives_pillows_bytes(factor, mode):
    """``resize_bicubic`` against Pillow's ``Image.resize`` at its default
    filter, on random uint8 images of odd and even sizes (1 to 97 a side,
    the output at least 1): every pixel equal."""
    rng = np.random.default_rng(SEED + factor)
    channels = {"RGB": (3,), "L": (), "RGBA": (4,), "LA": (2,)}[mode]
    for h, w in [(1, 1), (3, 97), (97, 5), (31, 33), (64, 48), (17, 90)] + [tuple(rng.integers(1, 98, 2))
                                                                          for _ in range(6)]:
        img = rng.integers(0, 256, (h, w) + channels, dtype=np.uint8)
        size = (max(1, w // factor), max(1, h // factor))
        want = np.asarray(Image.fromarray(img, mode).resize(size))
        got = tpdu.resize_bicubic(img, *size)
        assert got.shape == want.shape and np.array_equal(got, want), (h, w, np.abs(got.astype(int) - want).max())


def test_copy_images_matches_jax(tmp_path):
    """Pyramids of PNG and JPEG photos (RGB, grey, RGBA) from JAX's
    ``copy_images`` (Pillow) and the port's: the PNGs decode to the same
    pixels, the JPEGs are the same bytes (one encoder, the same pixels)."""
    rng = np.random.default_rng(SEED)
    for i, (ext, mode, hw) in enumerate([(".png", "RGB", (37, 53)), (".jpg", "RGB", (40, 24)),
                                         (".png", "L", (21, 18)), (".png", "RGBA", (16, 33)),
                                         (".jpeg", "RGB", (9, 15))]):
        write_photo(tmp_path / "src" / f"p{i}{ext}", rng, hw, mode)
    (tmp_path / "src" / "notes.txt").write_text("not an image")
    jp = jpdu.copy_images(tmp_path / "src", tmp_path / "j", num_downscales=3)
    tp = tpdu.copy_images(tmp_path / "src", tmp_path / "t", num_downscales=3)
    assert [p.name for p in tp] == [p.name for p in jp] and len(tp) == 5
    for level in ("images", "images_2", "images_4", "images_8"):
        for p in jp:
            a, b = tmp_path / "j" / level / p.name, tmp_path / "t" / level / p.name
            if p.suffix == ".png":
                want = np.asarray(Image.open(a))
                got = read_png(b)
                assert np.array_equal(got.reshape(want.shape), want), (level, p.name)
            else:
                assert b.read_bytes() == a.read_bytes(), (level, p.name)


def test_equirect_to_perspective_matches_jax():
    """Crops of a random float panorama at random views and sizes: 1e-6; of
    a uint8 one: equal."""
    rng = np.random.default_rng(SEED)
    pano = rng.uniform(0, 1, (40, 80, 3)).astype(np.float32)
    pano8 = rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)
    for fov, yaw, pitch, oh, ow in [(60.0, 0.0, 0.0, 16, 16), (120.0, 137.0, -45.0, 12, 20),
                                    (90.0, -170.0, 60.0, 9, 7), (100.0, 179.9, 89.0, 10, 10)]:
        np.testing.assert_allclose(teq.equirect_to_perspective(pano, fov, yaw, pitch, oh, ow),
                                   jeq.equirect_to_perspective(pano, fov, yaw, pitch, oh, ow), atol=1e-6)
        assert np.array_equal(teq.equirect_to_perspective(pano8, fov, yaw, pitch, oh, ow),
                              jeq.equirect_to_perspective(pano8, fov, yaw, pitch, oh, ow))
    for n in (1, 4, 6, 8, 14):
        for crop in [(0.0, 0.0, 0.0, 0.0), (0.3, 0.0, 0.1, 0.0), (0.0, 0.4, 0.0, 0.25)]:
            assert teq.sample_view_directions(n, crop) == jeq.sample_view_directions(n, crop)


def test_planar_projections_match_jax(tmp_path):
    """The crops of PNG panoramas (RGB and RGBA, which both packages read as
    RGB) written without Pillow equal JAX's; the resolution rule too."""
    rng = np.random.default_rng(SEED)
    write_photo(tmp_path / "pano0.png", rng, (32, 64), "RGB")
    write_photo(tmp_path / "pano1.png", rng, (32, 64), "RGBA")
    assert teq.compute_resolution_from_equirect(tmp_path, 6) == jeq.compute_resolution_from_equirect(tmp_path, 6)
    out = teq.generate_planar_projections_from_equirectangular(tmp_path, (12, 14), 6)
    files = sorted(out.glob("*.png"))
    want = {p.name: np.asarray(Image.open(p)) for p in sorted(out.glob("*.png"))}
    jeq.generate_planar_projections_from_equirectangular(tmp_path, (12, 14), 6)  # overwrites with Pillow's
    assert len(files) == 2 * len(teq.sample_view_directions(6))
    for p in files:
        assert np.array_equal(want[p.name], np.asarray(Image.open(p))), p.name


# ---------------------------------------------------------------------------
# the script and the binaries


def hide_binaries(monkeypatch):
    """No colmap, ffmpeg or hloc, whatever this machine has."""
    import shutil

    real = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None if name in ("colmap", "ffmpeg", "ffprobe")
                        else real(name, *a, **k))
    monkeypatch.setitem(sys.modules, "hloc", None)


def test_images_subcommand_writes_pyramids_then_refuses_sfm_as_jax(tmp_path, monkeypatch, capsys):
    """``images`` on a PNG folder with 3 downscales and no colmap binary:
    both scripts copy the images and write the pyramids, then refuse at the
    SfM step with the same error; the pyramids decode equal. ``--sfm-tool
    hloc`` refuses without hloc, as JAX's."""
    hide_binaries(monkeypatch)
    rng = np.random.default_rng(SEED)
    for i in range(3):
        write_photo(tmp_path / "photos" / f"img{i}.png", rng, (19, 26))
    errors = {}
    for side, script in (("j", jscript), ("t", tscript)):
        with pytest.raises(RuntimeError) as e:
            script.entrypoint(["images", "--data", str(tmp_path / "photos"), "--output-dir", str(tmp_path / side),
                               "--num-downscales", "3"])
        errors[side] = str(e.value)
        with pytest.raises(RuntimeError, match="hloc"):
            script.entrypoint(["images", "--data", str(tmp_path / "photos"), "--output-dir",
                               str(tmp_path / f"{side}_hloc"), "--sfm-tool", "hloc"])
    assert errors["t"] == errors["j"] and "colmap" in errors["t"]
    for level in ("images", "images_2", "images_4", "images_8"):
        names = sorted(p.name for p in (tmp_path / "j" / level).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "t" / level).iterdir()) and len(names) == 3
        for n in names:
            assert np.array_equal(read_png(tmp_path / "t" / level / n),
                                  np.asarray(Image.open(tmp_path / "j" / level / n)).reshape(
                                      read_png(tmp_path / "t" / level / n).shape))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tscript.entrypoint(["video", "--data", str(tmp_path / "v.mp4"), "--output-dir", str(tmp_path / "v")])
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tpdu.convert_video_to_images(tmp_path / "v.mp4", tmp_path / "frames")
    with pytest.raises(RuntimeError, match="hloc"):
        thloc.run_hloc(tmp_path, tmp_path / "colmap")


@pytest.mark.parametrize("sub", ["colmap", "polycam", "record3d", "metashape", "realitycapture", "odm"])
def test_converter_subcommands_match_jax(sub, tmp_path, capsys):
    """Each parsing subcommand through both scripts' flags: the same
    transforms.json."""
    rng = np.random.default_rng(SEED)
    data = tmp_path / "cap"
    if sub == "colmap":
        make_colmap_model(data, rng)
    elif sub == "polycam":
        for i in range(2):
            (data / "keyframes" / "cameras").mkdir(parents=True, exist_ok=True)
            cam = {"fx": 90.0, "fy": 91.0, "cx": 4.0, "cy": 4.0, "width": 8, "height": 8,
                   **{f"t_{r}{c}": float(rng.normal()) for r in range(3) for c in range(4)}}
            (data / "keyframes" / "cameras" / f"{i}.json").write_text(json.dumps(cam))
    elif sub == "record3d":
        data.mkdir()
        (data / "metadata").write_text(json.dumps({"K": [50.0, 0, 0, 0, 50.0, 0, 3.0, 3.0, 1], "poses":
                                                   [[0, 0, 0, 1, 1.0, 2.0, 3.0]]}))
        write_photo(data / "rgbd" / "0.png", rng)
    elif sub == "metashape":
        data = tmp_path / "cameras.xml"
        data.write_text('<document><chunk><sensors><sensor id="0"><calibration><resolution width="4" height="4"/>'
                        '<f>10</f></calibration></sensor></sensors><cameras><camera sensor_id="0" label="x.png">'
                        '<transform>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</transform></camera></cameras></chunk></document>')
    elif sub == "realitycapture":
        data = tmp_path / "poses.csv"
        data.write_text("#name,x,y,alt,heading,pitch,roll,f\nx.png,1,2,3,30,40,50,24\n")
    else:
        data = tmp_path / "reconstruction.json"
        data.write_text(json.dumps({"cameras": {"c": {"focal": 1.1, "width": 4, "height": 4}},
                                    "shots": {"x.png": {"camera": "c", "rotation": [0.1, 0.2, 0.3],
                                                        "translation": [1, 2, 3]}}}))
    extra = ["--image-dir", "imgs"] if sub in ("metashape", "realitycapture", "odm") else []
    for side, script in (("j", jscript), ("t", tscript)):
        script.entrypoint([sub, "--data", str(data), "--output-dir", str(tmp_path / side), *extra])
    same_files(tmp_path / "j", tmp_path / "t")


def test_run_colmap_refuses_without_the_binary(tmp_path, monkeypatch):
    hide_binaries(monkeypatch)
    for mod in (jcolmap, tcolmap):
        with pytest.raises(RuntimeError, match="colmap binary not found"):
            mod.run_colmap(tmp_path, tmp_path / "colmap")


def test_non_png_needs_pillow(tmp_path, monkeypatch):
    """Without Pillow a JPEG pyramid is refused with the PNG hint; PNGs
    still resize."""
    rng = np.random.default_rng(SEED)
    write_photo(tmp_path / "a" / "x.jpg", rng)
    write_photo(tmp_path / "b" / "x.png", rng)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PNG"):
        tpdu.copy_images(tmp_path / "a", tmp_path / "out_a", num_downscales=1)
    assert len(tpdu.copy_images(tmp_path / "b", tmp_path / "out_b", num_downscales=1)) == 1
    assert read_png(tmp_path / "out_b" / "images_2" / "frame_00001.png").shape == (6, 10, 3)


# ---------------------------------------------------------------------------
# plugins, completions, profiler, decorators


PLUGIN = '''
import copy
import dataclasses
from nerfstudio_torch.configs.method_configs import method_configs
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.plugins import DataParserSpecification, MethodSpecification

_config = copy.deepcopy(method_configs["nerfacto"])
_config.method_name = "my-method"
my_method = MethodSpecification(config=_config, description="a plugin's nerfacto")


@dataclasses.dataclass
class MyParserConfig(BlenderDataParserConfig):
    scale_factor: float = 0.25


my_parser = DataParserSpecification(config=MyParserConfig, description="a plugin's parser")
'''


def test_plugins_register_through_the_environment(tmp_path, monkeypatch):
    """``NERFSTUDIO_TORCH_METHOD_CONFIGS`` and
    ``NERFSTUDIO_TORCH_DATAPARSER_CONFIGS`` register a method and a parser
    (its ``-data`` alias too); the built-ins stay, generfacto among them
    with JAX's config field by field."""
    from nerfstudio_torch.configs.method_configs import NOT_PORTED, get_method
    from nerfstudio_torch.data.dataparsers.registry import dataparser_registry, get_dataparser_config

    (tmp_path / "my_plugin.py").write_text(PLUGIN)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("NERFSTUDIO_TORCH_METHOD_CONFIGS", "my-method=my_plugin:my_method")
    monkeypatch.setenv("NERFSTUDIO_TORCH_DATAPARSER_CONFIGS", "mine-data=my_plugin:my_parser")
    cfg = get_method("my-method")
    assert cfg.method_name == "my-method" and get_method("nerfacto").method_name == "nerfacto"
    assert cfg is not get_method("my-method")  # a fresh copy each time
    for name in ("mine-data", "mine"):
        parser = get_dataparser_config(name)
        assert type(parser).__name__ == "MyParserConfig" and parser.scale_factor == 0.25
    assert {"mine", "mine-data", "blender", "blender-data", "colmap"} <= set(dataparser_registry())
    from test_torch_vanilla_mipnerf import test_method_config_matches_jax as same_config

    assert "generfacto" not in NOT_PORTED
    same_config("generfacto")


@pytest.mark.parametrize("name", ["lerf", "kplanes-dynamic", "zipnerf", "no-such-method"])
def test_external_and_unknown_methods_exit_with_jax_text(name):
    """A catalogued external method exits with JAX's install text; an
    unknown one with the list of what there is."""
    from nerfstudio_tpu.configs.method_configs import get_method as jget
    from nerfstudio_torch.configs.method_configs import get_method as tget

    with pytest.raises(SystemExit) as t:
        tget(name)
    if name == "no-such-method":
        assert str(t.value).startswith("unknown method 'no-such-method'; available: ") and "nerfacto" in str(t.value)
        return
    with pytest.raises(SystemExit) as j:
        jget(name)
    assert str(t.value) == str(j.value) and "Install it first" in str(t.value)


def test_completions_list_the_ports_methods_and_parsers(tmp_path, monkeypatch):
    """The bash script names every method and parser and the scripts'
    subcommands, parses in bash, and completes a method, a parser and a
    subcommand; ``--mode install`` writes it under the home directory and
    sources it from the rc file once."""
    from nerfstudio_torch.configs.method_configs import method_configs
    from nerfstudio_torch.data.dataparsers.registry import dataparser_registry
    from nerfstudio_torch.scripts.completions import install

    script = install.generate_bash()
    for name in list(method_configs) + list(dataparser_registry()) + ["camera-path", "texture-mesh", "record3d"]:
        assert f" {name} " in script.replace('"', " "), name
    path = tmp_path / "completions.bash"
    path.write_text(script)
    probe = (f"source {path}\n"
             "COMP_WORDS=(python -m nerfstudio_torch.scripts.train nerfacto-b); COMP_CWORD=3; _nst_torch; "
             "echo ${COMPREPLY[@]}\n"
             "COMP_WORDS=(python -m nerfstudio_torch.scripts.train nerfacto --dataparser dnerf-d); COMP_CWORD=5; "
             "_nst_torch; echo ${COMPREPLY[@]}\n"
             "COMP_WORDS=(python -m nerfstudio_torch.scripts.process_data real); COMP_CWORD=3; _nst_torch; "
             "echo ${COMPREPLY[@]}\n")
    out = subprocess.run(["bash", "-c", probe], capture_output=True, text=True, check=True, timeout=60).stdout
    assert out.splitlines() == ["nerfacto-big", "dnerf-data", "realitycapture"]
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    rc = tmp_path / "rc"
    for _ in range(2):
        install.entrypoint(["--mode", "install", "--rc-file", str(rc)])
    target = tmp_path / "home" / ".config" / "nerfstudio_torch" / "completions.bash"
    assert target.read_text() == script and rc.read_text().count(f"source {target}") == 1


def test_profiler_times_functions_and_traces_steps(tmp_path, monkeypatch, capsys):
    """``time_function`` records nothing until ``enable_profiler``, then
    the running average that ``flush_profiler`` prints; ``PytorchProfiler``
    writes a chrome trace of its steps."""
    from nerfstudio_torch.utils import profiler

    monkeypatch.setattr(profiler, "_PROFILER_ENABLED", False)
    monkeypatch.setattr(profiler, "_STATS", type(profiler._STATS)(lambda: [0.0, 0]))

    @profiler.time_function
    def work(x):
        return torch.ones(64, 64) @ torch.ones(64, 64) * x

    work(1)
    assert not profiler._STATS
    profiler.enable_profiler()
    for i in range(3):
        work(i)
    (name, (total, count)), = profiler._STATS.items()
    assert name.endswith("work") and count == 3 and total > 0
    profiler.flush_profiler()
    assert "work" in capsys.readouterr().out
    prof = profiler.PytorchProfiler(tmp_path, trace_steps=(1, 2))
    for step in range(4):
        prof.step_start(step)
        work(step)
        prof.step_end(step)
    trace = json.loads((tmp_path / "profiler_traces" / "trace_1-2.json").read_text())
    assert any("aten::mm" in e.get("name", "") for e in trace["traceEvents"])


def test_decorators(monkeypatch):
    from nerfstudio_torch.utils import decorators

    @decorators.check_main_thread
    def main_only():
        return "ran"

    class Owner:
        def __init__(self, viewer, cfg):
            self.viewer, self.config = viewer, cfg

        @decorators.check_viewer_enabled
        def view(self):
            return "viewed"

        @decorators.check_eval_enabled
        def evaluate(self):
            return "evaluated"

    assert main_only() == "ran"  # no process group: the one process is the main one
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert main_only() is None
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    assert main_only() == "ran"
    off = type("C", (), {"steps_per_eval_image": 0, "steps_per_eval_batch": 0, "steps_per_eval_all_images": 0})
    on = type("C", (), {"steps_per_eval_image": 0, "steps_per_eval_batch": 5, "steps_per_eval_all_images": 0})
    assert Owner(None, off).view() is None and Owner(object(), off).view() == "viewed"
    assert Owner(None, off).evaluate() is None and Owner(None, on).evaluate() == "evaluated"
