"""The port's render and export CLIs end to end on the CPU, as
tests/test_cli_surfaces.py drives the JAX package's: a 4-step nerfacto run
and a 4-step splatfacto run through ``scripts.train`` (``--machine.device_type
cpu``), then every render subcommand and every export mode through
``main(argv)``. The files are checked as chip_smoke.py's phase 70 checks
them on the card: each PLY's vertex count matches its header and its size,
the PNG frames decode through the port's reader at the frame's size, the
meshes are non-empty, the OBJ's faces are the density mesh's."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)
import torch

sys.path.insert(0, str(Path(__file__).parent))
from fixtures import make_nerfstudio_fixture  # noqa: E402

HW = 16
# tiny nerfacto, starting dense enough (average_init_density 1) that its
# untrained field has surfaces and opaque pixels to export
NERFACTO = ["--datamanager.train_num_rays_per_batch", "64", "--model.log2_hashmap_size", "12", "--model.max_res",
            "64", "--model.occ_grid_resolution", "16", "--model.hidden_dim", "16", "--model.hidden_dim_color", "16",
            "--model.num_nerf_samples_per_ray", "8", "--model.eval_num_rays_per_chunk", "512",
            "--model.average_init_density", "1.0"]
SPLAT = ["--model.max_gaussians", "300", "--model.num_random", "100", "--model.random_init", "true"]


def ply_vertices(path: Path) -> int:
    """The vertex count of a binary PLY the exporter wrote, checked against
    the bytes after its header."""
    data = path.read_bytes()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    assert lines[:2] == ["ply", "format binary_little_endian 1.0"], lines[:2]
    n = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
    width = sum(4 if l.split()[1] == "float" else 1 for l in lines if l.startswith("property"))
    assert len(body) == n * width, (path, n, width, len(body))
    return n


def png_frames(directory: Path, hw, count: int) -> None:
    from nerfstudio_torch.data.image_io import read_image

    frames = sorted(directory.glob("*.png"))
    assert len(frames) == count, (directory, len(frames))
    for f in frames:
        img = read_image(f)
        assert img.dtype == np.uint8 and img.shape == hw + (3,), (f, img.shape)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from nerfstudio_torch.scripts import train

    root = tmp_path_factory.mktemp("render_export")
    scene = make_nerfstudio_fixture(root / "scene", n=5, hw=HW)
    out = {}
    for method, extra in (("nerfacto", NERFACTO), ("splatfacto", SPLAT)):
        train.main([method, "--data", str(scene), "--machine.device_type", "cpu", "--trainer.output_dir",
                    str(root / "out"), "--trainer.vis", "none", "--trainer.steps_per_save", "4",
                    "--trainer.max_num_iterations", "4", "--trainer.timestamp", "run", *extra])
        out[method] = root / "out" / "scene" / method / "run"
    return root, out


def camera_path_json(path: Path, camera_type: str, hw=(12, 20)) -> Path:
    """A viewer keyframe JSON of two cameras looking at the origin."""
    from fixtures import look_at_origin

    cams = [{"camera_to_world": look_at_origin(np.array(p)).reshape(-1).tolist(), "fov": 60.0, "render_time": t}
            for p, t in (([3.0, 0.0, 1.5], 0.0), ([0.0, 3.0, 1.5], 1.0))]
    path.write_text(json.dumps({"render_height": hw[0], "render_width": hw[1], "camera_type": camera_type,
                                "camera_path": cams}))
    return path


@pytest.mark.parametrize("method", ["nerfacto", "splatfacto"])
def test_render_subcommands(runs, method, tmp_path):
    from nerfstudio_torch.scripts import render

    _, run = runs[0], runs[1][method]
    base = ["--load-config", str(run), "--rendered-output-names", "rgb,depth"]
    cases = [(["dataset"], (HW, 2 * HW), 1), (["spiral", "--steps", "3"], (HW, 2 * HW), 3),
             (["interpolate", "--steps", "2"], (HW, 2 * HW), 8)]
    for camera_type in ("fisheye", "equirectangular"):
        path = camera_path_json(tmp_path / f"{camera_type}.json", camera_type)
        cases.append((["camera-path", "--camera-path-filename", str(path)], (12, 40), 2))
    for args, hw, count in cases:
        out = tmp_path / f"{args[0]}_{args[-1].split('/')[-1]}"
        info = render.main(args[:1] + base + args[1:] + ["--output-path", str(out)])
        assert info["frames"] == count and Path(info["output"]) == out
        png_frames(out, hw, count)


def test_render_writes_png_frames_without_a_video_writer(runs, tmp_path, monkeypatch, capsys):
    """A ``.mp4`` output without imageio: the frames go to a directory of
    that name, and a line says so."""
    from nerfstudio_torch.scripts import render

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    out = tmp_path / "video.mp4"
    info = render.main(["dataset", "--load-config", str(runs[1]["nerfacto"]), "--output-path", str(out)])
    assert info["output"] == str(out) and out.is_dir()
    png_frames(out, (HW, HW), 1)
    assert f"writing PNG frames into the directory {out} instead" in capsys.readouterr().out


def test_render_refuses_unknown_flags(runs):
    from nerfstudio_torch.scripts import render

    with pytest.raises(SystemExit, match="unrecognized arguments"):
        render.main(["dataset", "--load-config", str(runs[1]["nerfacto"]), "--fsp", "3"])


def test_export_modes_of_a_nerfacto_run(runs, tmp_path):
    from nerfstudio_torch.scripts import exporter
    from nerfstudio_torch.utils.eval_utils import eval_setup

    run = runs[1]["nerfacto"]
    out = tmp_path / "exports"
    for args in (["pointcloud", "--num-points", "500"], ["cameras"], ["marching-cubes", "--resolution", "12"],
                 ["tsdf", "--resolution", "16", "--num-views", "3"], ["poisson", "--num-points", "800",
                                                                      "--resolution", "16"],
                 ["texture-mesh", "--resolution", "8"]):
        exporter.main(args[:1] + ["--load-config", str(run), "--output-dir", str(out)] + args[1:])
    assert 0 < ply_vertices(out / "point_cloud.ply") <= 500
    cams = json.loads((out / "cameras.json").read_text())
    assert len(cams) == 5 and cams[0]["type"] == "PinholeCamera" and len(cams[0]["camera_to_world"]) == 3
    assert ply_vertices(out / "mesh_points.ply") > 0
    for name in ("tsdf", "poisson"):
        faces = np.load(out / f"{name}_faces.npy")
        n = ply_vertices(out / f"{name}_mesh.ply")
        assert n > 0 and len(faces) > 0 and faces.max() < n
    _, pipeline, _ = eval_setup(run)
    verts, faces = exporter.density_mesh(pipeline, 8)
    obj = (out / "textured_mesh.obj").read_text().splitlines()
    assert sum(l.startswith("f ") for l in obj) == len(faces) > 0
    assert sum(l.startswith("v ") for l in obj) == len(verts)
    assert sum(l.startswith("vt ") for l in obj) == 3 * len(faces)
    from nerfstudio_torch.data.image_io import read_image

    tex = read_image(out / "textured_mesh.png")
    assert tex.dtype == np.uint8 and tex.shape[-1] == 3 and tex.shape[0] % 8 == 0


def test_export_modes_of_a_splatfacto_run(runs, tmp_path):
    from nerfstudio_torch.scripts import exporter
    from nerfstudio_torch.utils.eval_utils import eval_setup

    run = runs[1]["splatfacto"]
    out = tmp_path / "exports"
    exporter.main(["gaussian-splat", "--load-config", str(run), "--output-dir", str(out)])
    exporter.main(["cameras", "--load-config", str(run), "--output-dir", str(out)])
    _, _, state = eval_setup(run)
    assert ply_vertices(out / "splat.ply") == int(state.aux.alive.sum()) > 0
    head = (out / "splat.ply").read_bytes().split(b"end_header\n")[0].decode()
    names = [l.split()[-1] for l in head.splitlines() if l.startswith("property")]
    k = state.params["features_rest"].shape[1]
    assert names == (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
                     + [f"f_rest_{i}" for i in range(3 * k)] + ["opacity", "scale_0", "scale_1", "scale_2"]
                     + [f"rot_{i}" for i in range(4)])
    assert len(json.loads((out / "cameras.json").read_text())) == 5


def test_render_camera_of_the_pipeline_renders_the_eval_views(runs):
    """``render_camera`` on the eval cameras is the eval render."""
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, state = eval_setup(runs[1]["nerfacto"])
    a = pipeline.render_camera(state, pipeline.datamanager.eval_cameras, 0)
    b = pipeline.render_eval_camera(state, 0)
    for key in ("rgb", "depth", "accumulation"):
        assert torch.equal(a[key], b[key])
