"""The port's viewer (``nerfstudio_torch/viewer/``) on the CPU, against the
JAX package's where both have the piece: the widgets' coercion, specs and
scan, click rays and ``get_camera``, the render panel's interpolated paths,
FOV tracks and path JSON, the control panel and the frustum overlay; the
preview render against JAX's ``render_camera(..., preview=True)`` and the
viewer's colormaps against JAX's ``Viewer.render_view``; the standard
library websocket server on a tiny nerfacto and a tiny splat state, driven
by the ``websockets`` client library (as JAX's tests drive theirs) and by a
raw-socket client (masked frames of 7-, 16- and 64-bit lengths, fragments,
ping, close, a vanished client), every frame decoding to the port's own
render of its camera; and a live CPU training run, viewed while it steps
and paused once, bit-equal to the same run without a viewer."""

import asyncio
import base64
import dataclasses
import json
import os
import socket
import struct
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import CPU, HW, NUM_IMAGES, init_params, jax_tiny_nerfacto, orbit_c2w, sphere_grid_binary, \
    torch_tiny_nerfacto
from fixtures import make_blender_fixture, make_nerfstudio_fixture
from test_torch_cli import TINY
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.ops import occupancy as jocc
from nerfstudio_tpu.pipelines.base_pipeline import TrainState as JTrainState
from nerfstudio_tpu.pipelines.base_pipeline import VanillaPipeline as JPipeline
from nerfstudio_tpu.viewer import panels as jpanels
from nerfstudio_tpu.viewer import viewer_elements as jve
from nerfstudio_tpu.viewer.server import Viewer as JViewer
from nerfstudio_torch.cameras.cameras import Cameras
from nerfstudio_torch.configs.cli import apply_overrides
from nerfstudio_torch.configs.method_configs import get_method
from nerfstudio_torch.data.dataparsers.registry import get_dataparser_config
from nerfstudio_torch.data.image_io import decode_png
from nerfstudio_torch.ops import hash_grid
from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline
from nerfstudio_torch.utils.convert import occupancy_from_jax, params_from_jax
from nerfstudio_torch.viewer import panels as tpanels
from nerfstudio_torch.viewer import server as tserver
from nerfstudio_torch.viewer import viewer_elements as tve

RNG_SEED = 23


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def random_pose(rng) -> np.ndarray:
    """(3, 4) float32: a random rotation (QR of a normal matrix, det +1) and
    a translation in +-2."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return np.concatenate([q, rng.uniform(-2, 2, (3, 1))], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# widgets, panels


WIDGETS = [
    ("ViewerSlider", ("noise", 0.5, 0.0, 1.0), {"step": 0.1}, [2.5, -1, "0.3", 0.7]),
    ("ViewerNumber", ("n", 0.0), {}, ["3.5", 7, -0.25]),
    ("ViewerText", ("t", ""), {}, [7, "abc", 1.5]),
    ("ViewerCheckbox", ("c", False), {}, [1, 0, "x", ""]),
    ("ViewerDropdown", ("mode", "rgb", ["rgb", "depth"]), {}, ["bogus", "depth", "rgb"]),
    ("ViewerButtonGroup", ("split", "full", ["full", "half"]), {}, ["half", "none"]),
    ("ViewerRGB", ("rgb", (0, 0, 0)), {}, [[300, -5, 128.7], [1, 2, 3]]),
    ("ViewerVec3", ("v", (0, 0, 0)), {"step": 0.5}, [[1, 2, 3], ["0.5", -1, 2.25]]),
    ("ViewerButton", ("export now",), {}, [True]),
]


@pytest.mark.parametrize("kind, args, kwargs, values", WIDGETS, ids=[w[0] for w in WIDGETS])
def test_widgets_match_jax(kind, args, kwargs, values):
    """Each widget's spec, coerced value and callback, value by value, equal
    to the JAX class's on the same inputs."""
    fired = {"jax": [], "torch": []}
    widgets = {}
    for side, mod in (("jax", jve), ("torch", tve)):
        widgets[side] = getattr(mod, kind)(*args, **kwargs,
                                          cb_hook=lambda e, side=side: fired[side].append(getattr(e, "value", e.name)))
    assert widgets["torch"].to_spec() == widgets["jax"].to_spec()
    for v in values:
        for w in widgets.values():
            w.handle(v)
        assert widgets["torch"].to_spec() == widgets["jax"].to_spec()
    assert fired["torch"] == fired["jax"] and len(fired["torch"]) == len(values)
    if kind == "ViewerDropdown":
        for w in widgets.values():
            w.set_options(["a", "b"])
        assert widgets["torch"].value == widgets["jax"].value == "a"


def test_collect_viewer_elements_matches_jax():
    """The attribute scan finds the same qualified names on the same object
    tree (nested components, lists, dicts, each element once)."""
    found = {}
    for side, mod in (("jax", jve), ("torch", tve)):
        class Field:
            def __init__(self):
                self.knobs = [mod.ViewerSlider("a", 0.0, 0.0, 1.0), mod.ViewerCheckbox("b", True)]
                self.named = {"x": mod.ViewerText("x", "")}

        class Model:
            def __init__(self):
                self.field = Field()
                self.ctl = mod.ViewerControl()
                self.other = 42

        class Pipeline:
            def __init__(self):
                self.model = Model()
                self.check = mod.ViewerCheckbox("k", True)

        p = Pipeline()
        found[side] = [name for name, _ in mod.collect_viewer_elements(p, p, p.model)]
    assert found["torch"] == found["jax"] and len(found["torch"]) == 5


def test_click_rays_rects_and_get_camera_match_jax():
    """Clicks and rectangle corners lifted to world rays, and ``get_camera``,
    at random poses and fields of view: 1e-6."""
    rng = np.random.default_rng(RNG_SEED)
    for _ in range(8):
        fake = types.SimpleNamespace(camera_pose=random_pose(rng), camera_fov=float(rng.uniform(20, 120)),
                                     device=CPU)
        got = {"jax": [], "torch": []}
        ctls = {}
        for side, mod in (("jax", jve), ("torch", tve)):
            ctls[side] = mod.ViewerControl()
            ctls[side].install(fake)
            ctls[side].register_click_cb(got[side].append)
            ctls[side].register_rect_cb(got[side].append)
        for u, v in rng.uniform(0, 1, (4, 2)):
            a, b = ctls["jax"].on_click(u, v), ctls["torch"].on_click(u, v)
            np.testing.assert_allclose(b.origin, a.origin, atol=1e-6)
            np.testing.assert_allclose(b.direction, a.direction, atol=1e-6)
            assert b.screen_pos == a.screen_pos
        u0, v0, u1, v1 = rng.uniform(0, 1, 4)
        a, b = ctls["jax"].on_rect(u0, v0, u1, v1), ctls["torch"].on_rect(u0, v0, u1, v1)
        for ra, rb in ((a.ray_min, b.ray_min), (a.ray_max, b.ray_max)):
            np.testing.assert_allclose(rb[0], ra[0], atol=1e-6)
            np.testing.assert_allclose(rb[1], ra[1], atol=1e-6)
        assert len(got["torch"]) == len(got["jax"]) == 5
        h, w = (int(x) for x in rng.integers(8, 300, 2))
        jc, tc = ctls["jax"].get_camera(h, w), ctls["torch"].get_camera(h, w)
        assert isinstance(tc, Cameras) and tc.camera_to_worlds.device.type == "cpu"
        np.testing.assert_allclose(tc.camera_to_worlds.numpy(), np.asarray(jc.camera_to_worlds), atol=1e-6)
        for f in ("fx", "fy", "cx", "cy", "width", "height"):
            np.testing.assert_allclose(getattr(tc, f).numpy().reshape(-1), np.asarray(getattr(jc, f)).reshape(-1),
                                       rtol=1e-6, err_msg=f)


def keyframed_panels(rng, n: int, loop: bool):
    """A JAX and a port RenderPanel with the same ``n`` random keyframes."""
    panels = jpanels.RenderPanel(), tpanels.RenderPanel()
    poses = [random_pose(rng) for _ in range(n)]
    fovs = rng.uniform(30, 90, n)
    for p in panels:
        for c2w, fov in zip(poses, fovs):
            p.add_keyframe(c2w, fov)
        p.loop = loop
    return panels


@pytest.mark.parametrize("n, loop, frames", [(2, False, 10), (3, False, 20), (3, True, 24), (5, True, 50)])
def test_interpolated_paths_and_fov_tracks_match_jax(n, loop, frames):
    """Poses and per-frame FOVs along the keyframe path, closed or open: 1e-6."""
    jp, tp = keyframed_panels(np.random.default_rng(RNG_SEED + n), n, loop)
    jposes, jfovs = jp.interpolated_path(frames, return_fovs=True)
    tposes, tfovs = tp.interpolated_path(frames, return_fovs=True)
    assert tposes.shape == jposes.shape and tfovs.shape == jfovs.shape
    np.testing.assert_allclose(tposes, jposes, atol=1e-6)
    np.testing.assert_allclose(tfovs, jfovs, atol=1e-6)


def test_path_json_round_trips_byte_equal_to_jax(tmp_path):
    """The saved camera path is JAX's byte for byte; both load it back to
    the same keyframes, and saving again gives the same bytes."""
    jp, tp = keyframed_panels(np.random.default_rng(RNG_SEED), 4, True)
    jp.set_keyframe_fov(1, 75.0)
    tp.set_keyframe_fov(1, 75.0)
    a = jp.save_path_json(tmp_path / "jax" / "camera_path.json", resolution=64, fps=10, seconds=2.0)
    b = tp.save_path_json(tmp_path / "torch" / "camera_path.json", resolution=64, fps=10, seconds=2.0)
    assert b.read_bytes() == a.read_bytes()
    jq, tq = jpanels.RenderPanel(), tpanels.RenderPanel()
    assert tq.load_path_json(a) == jq.load_path_json(a) == 4
    assert tq.keyframes == jq.keyframes and tq.loop is jq.loop is True
    assert tq.save_path_json(tmp_path / "again.json", 64, 10, 2.0).read_bytes() == a.read_bytes()


def test_control_panel_and_frustums_match_jax():
    updates = {"output_type": "depth", "max_resolution": "96", "train_util": 0.5, "show_cameras": 1,
               "colormap": "gray", "colormap_max": 4, "background_color": "#2040ff", "time": "0.25",
               "crop_enabled": True, "crop_min": [-0.5, -0.5, -0.5], "crop_max": ["0.5", 1, 2], "unknown": 1}
    j, t = jpanels.ControlPanelState(), tpanels.ControlPanelState()
    j.apply(updates)
    t.apply(updates)
    assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.background_rgb() == j.background_rgb()
    rng = np.random.default_rng(RNG_SEED)
    image = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    view = orbit_c2w(1)[0]
    train = orbit_c2w(6)
    assert np.array_equal(tpanels.draw_camera_frustums(image, view, 40.0, train),
                          jpanels.draw_camera_frustums(image, view, 40.0, train))


# ---------------------------------------------------------------------------
# the preview render and the viewer's colormaps


@pytest.fixture(scope="module")
def tiny():
    """A tiny nerfacto in both packages: the JAX eval model, its params (hash
    tables redrawn in +-1), an occupancy grid over a sphere, and the cameras."""
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
    # one JAX pipeline for every test: it compiles its eval chunks once
    jpipe = JPipeline(types.SimpleNamespace(eval_dataset=None, train_cameras=jcams), jmodel, jmodel, None)
    return types.SimpleNamespace(jmodel=jmodel, cfg=cfg, jgrid=jgrid, jcams=jcams, cam_args=cam_args, params=params,
                                 jpipe=jpipe)


def zeroed_tables(params):
    """Every hash table zeroed: K1 returns 0 whichever vertex it rounds to."""
    params = jax.tree_util.tree_map(np.copy, params)

    def zero(path, x):
        return np.zeros_like(x) if jax.tree_util.keystr(path).endswith("['hash_table']") else x

    return jax.tree_util.tree_map_with_path(zero, params)


def pipelines(tiny, params):
    """(JAX pipeline, JAX state, port pipeline, port state) over the same
    params and grid, the port's model left in training mode."""
    jpipe = tiny.jpipe
    jstate = JTrainState(params=params, opt_state=None, step=jnp.zeros((), jnp.int32), aux=tiny.jgrid)
    model = torch_tiny_nerfacto(train=True)
    model.load_state_dict(params_from_jax(params, model))
    cams = Cameras.create(*tiny.cam_args, device=CPU)
    dm = types.SimpleNamespace(device=torch.device(CPU), eval_dataset=None, train_cameras=cams)
    tpipe = VanillaPipeline(dm, model)
    return jpipe, jstate, tpipe, TrainState(optimizer=None, aux=occupancy_from_jax(tiny.jgrid))


@pytest.mark.parametrize("variant", ["k1_neutral", "k1_live"])
def test_preview_render_matches_jax(tiny, variant):
    """``render_camera(..., preview=True)`` against JAX's: the field through
    K1's stochastic trilerp (its twin here), the training model's mode left
    as it was. Neutral (every table zeroed, so K1 returns 0 whatever it
    rounds): every output within 1e-5. Live (tables in +-1): rgb mean abs
    <= 1.5e-2, accumulation <= 4e-2 (measured ~7e-3 and ~2e-2): K1 hashes
    the float bits of each sample's cell offset, and positions an ulp apart
    (the packages sum the PDF weights in another order) redraw the odd-axis
    rounding of the field's samples as well as the proposal's; the exact
    render's test holds 5e-3 and 1e-2 (test_torch_nerfacto_render.py). The
    live preview differs from the exact render: it is not K3."""
    params = zeroed_tables(tiny.params) if variant == "k1_neutral" else tiny.params
    jpipe, jstate, tpipe, tstate = pipelines(tiny, params)
    ref = jpipe.render_camera(params, tiny.jcams, 1, HW * HW, aux=tiny.jgrid, preview=True)
    hash_grid.reset_launch_counts()
    got = {k: v.numpy() for k, v in tpipe.render_camera(tstate, tpipe.datamanager.train_cameras, 1, HW * HW,
                                                       preview=True).items()}
    assert tpipe.model.training  # the training model's mode untouched
    assert not any(hash_grid.launch_counts.values())  # the CPU ran the twins
    twin = tpipe.preview_model()
    assert not twin.training and not twin.config.eval_exact_trilerp and tpipe.model.config.eval_exact_trilerp
    assert twin.field.mlp_base.encoding.hash_table is tpipe.model.field.mlp_base.encoding.hash_table
    assert not twin.field.mlp_base.encoding.block_exact and tpipe.model.field.mlp_base.encoding.block_exact
    for k in ("rgb", "accumulation", "depth", "expected_depth"):
        assert got[k].shape == ref[k].shape, k
        err = np.abs(got[k] - ref[k])
        if variant == "k1_neutral":
            assert err.max() <= 1e-5 * max(1.0, np.abs(ref[k]).max()), (k, err.max())
        elif k in ("rgb", "accumulation"):
            assert err.mean() <= (1.5e-2 if k == "rgb" else 4e-2), (k, err.mean())
    if variant == "k1_live":
        exact = tpipe.render_camera(tstate, tpipe.datamanager.train_cameras, 1, HW * HW)
        assert not torch.equal(exact["rgb"], torch.from_numpy(got["rgb"]))
        assert tpipe.model.training


@pytest.mark.parametrize("output, colormap, preview", [("depth", "turbo", False), ("depth", "gray", True),
                                                       ("accumulation", "viridis", True)])
def test_render_view_colormaps_match_jax(tiny, output, colormap, preview):
    """``Viewer.render_view`` of both packages at one pose under the control
    panel's output, colormap, inverted map and depth range, with every hash
    table zeroed (K1 neutral): 1e-5."""
    params = zeroed_tables(tiny.params)
    jpipe, jstate, tpipe, tstate = pipelines(tiny, params)
    jv = JViewer(jpipe, lambda: jstate)
    tv = tserver.Viewer(tpipe, lambda: tstate)
    pose, fov, res = orbit_c2w(NUM_IMAGES)[2], 50.0, HW
    focal = res / (2 * np.tan(np.deg2rad(fov) / 2))
    jcam = JCameras(pose[None], focal, focal, res / 2, res / 2, res, res)
    for v in (jv, tv):
        v.control.apply({"output_type": output, "colormap": colormap, "colormap_max": 3.0, "depth_near": 0.5,
                         "invert_colormap": colormap == "gray"})
    ref = jv.render_view(jcam, res, preview=preview)
    got = tv.render_view(tv.camera(pose, fov, res), res, preview=preview)
    assert got.shape == ref.shape == (res, res, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert tpipe.model.training


# ---------------------------------------------------------------------------
# the server


def wait_for_port(port: int) -> None:
    for _ in range(100):
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"nothing listens on {port}")


def start_viewer(pipeline, state, tmp_path, max_resolution=16, **kw):
    v = tserver.Viewer(pipeline, lambda: state, websocket_port=free_port(), http_port=free_port(),
                       max_resolution=max_resolution, **kw)
    v.output_dir = tmp_path
    v.start()
    wait_for_port(v.websocket_port)
    return v


@pytest.fixture
def ray_viewer(tiny, tmp_path):
    """The port's viewer on the tiny nerfacto (live tables) at 16^2, with a
    slider and a click-listening ViewerControl on its model."""
    _, _, tpipe, tstate = pipelines(tiny, tiny.params)
    tpipe.model.config = dataclasses.replace(tpipe.model.config, eval_num_rays_per_chunk=256)
    fired, clicks = [], []
    tpipe.model.noise = tve.ViewerSlider("noise", 0.2, 0.0, 1.0, cb_hook=lambda e: fired.append(e.value))
    tpipe.model.ctl = tve.ViewerControl()
    tpipe.model.ctl.register_click_cb(clicks.append)
    v = start_viewer(tpipe, tstate, tmp_path)
    v.control.apply({"train_util": 0.0})  # no training to yield to
    v.fired, v.clicks, v.state = fired, clicks, tstate
    yield v
    v.stop()


def camera_message(radius: float = 3.0, fov: float = 60.0, pad: int = 0) -> dict:
    c2w = orbit_c2w(NUM_IMAGES)[1].copy()
    c2w[:, 3] *= radius / np.linalg.norm(c2w[:, 3])
    msg = {"type": "camera", "c2w": c2w.reshape(-1).tolist(), "fov": fov}
    if pad:
        msg["pad"] = "x" * pad
    return msg


def expected_frame(viewer, frame) -> np.ndarray:
    """The port's own render of the frame's camera and mode, quantised as
    the viewer quantises."""
    pose = np.asarray(frame["c2w"], np.float32).reshape(3, 4)
    cam = viewer.camera(pose, frame["fov"], frame["res"])
    out = viewer.pipeline.render_camera(viewer.state, cam, 0, frame["res"] ** 2, preview=frame["preview"])
    return tpanels.to_uint8(out["rgb"].numpy())


def drive(viewer, messages, want_frames=1, timeout=30.0, until=None):
    """Connect with the ``websockets`` client, send ``messages`` and collect
    (frames, other messages) until ``want_frames`` frames (and ``until()``)."""
    websockets = pytest.importorskip("websockets")

    async def run():
        frames, others = [], []
        async with websockets.connect(f"ws://127.0.0.1:{viewer.websocket_port}", max_size=None) as ws:
            for m in messages:
                await ws.send(json.dumps(m))
            t0 = time.time()
            while (len(frames) < want_frames or (until is not None and not until())) and time.time() - t0 < timeout:
                try:
                    msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=1.0))
                except asyncio.TimeoutError:
                    continue
                (frames if msg.get("type") == "frame" else others).append(msg)
        return frames, others

    return asyncio.run(run())


def test_frames_are_the_ports_renders(ray_viewer):
    """A camera message gives the preview (K1) frames, then the exact one;
    each PNG decodes to the port's render of that camera, byte for byte.
    The scene payload on connect carries the training cameras."""
    frames, others = drive(ray_viewer, [camera_message()], want_frames=3)
    assert len(frames) >= 3 and frames[0]["preview"] and not frames[-1]["preview"]
    for f in frames:
        assert f["res"] == 16 and f["render_ms"] > 0 and f["encode_ms"] > 0
        assert np.array_equal(decode_png(base64.b64decode(f["image"])), expected_frame(ray_viewer, f))
    scene = next(m for m in others if m["type"] == "scene")
    assert len(scene["cameras"]) == NUM_IMAGES and len(scene["cameras"][0]) == 12
    assert ray_viewer.errors == []


def test_settings_keyframes_path_and_snapshot(ray_viewer):
    drive(ray_viewer, [camera_message(2.5), {"type": "keyframe_add"}, camera_message(3.5), {"type": "keyframe_add"},
                       {"type": "path_save", "fps": 10, "seconds": 1.0, "resolution": 64},
                       {"type": "setting", "updates": {"output_type": "depth", "colormap": "gray",
                                                       "background_color": "#2040ff"}},
                       {"type": "snapshot"}], want_frames=2,
          until=lambda: list((ray_viewer.output_dir / "snapshots").glob("*.png")))
    assert ray_viewer.control.output_type == "depth" and ray_viewer.control.colormap == "gray"
    assert ray_viewer.control.background_rgb() == pytest.approx((0x20 / 255, 0x40 / 255, 1.0))
    payload = json.loads((ray_viewer.output_dir / "camera_path.json").read_text())
    assert len(payload["keyframes"]) == 2 and len(payload["camera_path"]) >= 2
    assert len(payload["camera_path"][0]["camera_to_world"]) == 16
    (snap,) = (ray_viewer.output_dir / "snapshots").glob("*.png")
    assert decode_png(snap.read_bytes()).shape == (16, 16, 3)
    drive(ray_viewer, [{"type": "keyframe_delete", "index": 0}], want_frames=0, timeout=1.0)
    assert len(ray_viewer.render_panel.keyframes) == 1


def test_render_path_and_exports(ray_viewer):
    """The render panel's path render writes one PNG per frame, each the
    viewer's render of its path camera; the export panel writes the
    cameras and a point cloud from the viewer's own copy of the model."""
    from nerfstudio_torch.exporter.ply_io import read_ply

    v = ray_viewer
    out = v.output_dir
    drive(v, [camera_message(2.5), {"type": "keyframe_add"}, camera_message(3.5), {"type": "keyframe_add"},
              {"type": "render_path", "frames": 4, "resolution": 12}], want_frames=1,
          until=lambda: v.render_panel.status.startswith(("done", "error")))
    assert v.render_panel.status.startswith("done"), v.render_panel.status
    frames = sorted((out / "render").glob("frame_*.png"))
    poses, fovs = v.render_panel.interpolated_path(4, return_fovs=True)
    assert len(frames) == len(poses) >= 4
    for f, c2w, fov in zip(frames, poses, fovs):
        want = tpanels.to_uint8(v.render_view(v.camera(c2w, fov, 12), 12))
        assert np.array_equal(decode_png(f.read_bytes()), want), f.name
    for kind in ("cameras", "pointcloud"):
        v.export_panel.status = "idle"
        drive(v, [{"type": "export", "kind": kind, "num_points": 300}], want_frames=0, timeout=60,
              until=lambda: v.export_panel.status.startswith(("done", "error")))
        assert v.export_panel.status.startswith("done"), v.export_panel.status
    cams = json.loads((out / "exports" / "transforms_train.json").read_text())
    assert len(cams) == NUM_IMAGES and len(cams[0]["camera_to_world"]) == 4
    pts, rgb = read_ply(out / "exports" / "pointcloud.ply")
    assert 0 < len(pts) <= 300 and np.isfinite(pts).all() and rgb.shape == pts.shape
    assert v.pipeline.model.training and v.errors == []


def test_custom_widget_and_click(ray_viewer):
    """The custom panel is the first message on connect; a widget update
    reaches its callback, a click its ViewerControl as a world ray."""
    v = ray_viewer
    frames, others = drive(v, [camera_message(), {"type": "custom", "id": "VanillaPipeline.model.noise", "value": 0.7},
                               {"type": "click", "u": 0.5, "v": 0.5}], want_frames=1,
                           until=lambda: v.fired and v.clicks)
    assert others[0]["type"] == "custom_panel"
    (spec,) = others[0]["elements"]
    assert spec["id"] == "VanillaPipeline.model.noise" and spec["kind"] == "slider"
    assert v.fired == [pytest.approx(0.7)] and len(v.clicks) == 1
    pose = np.asarray(camera_message()["c2w"], np.float32).reshape(3, 4)
    np.testing.assert_allclose(v.clicks[0].direction, -pose[:, 2] / np.linalg.norm(pose[:, 2]), atol=1e-6)


def test_http_serves_the_client_page(ray_viewer):
    html = urllib.request.urlopen(f"http://127.0.0.1:{ray_viewer.http_port}/", timeout=5).read().decode()
    assert "nerfstudio-torch viewer" in html and str(ray_viewer.websocket_port) in html
    assert "data:image/png;base64," in html and "msg.image" in html


class RawClient:
    """A websocket client on a bare socket: masked frames of any length,
    fragments and control frames, as RFC 6455 asks of a client."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += self.sock.recv(1)
        lines = head.decode().split("\r\n")
        assert lines[0].startswith("HTTP/1.1 101"), lines[0]
        headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
        assert headers["Sec-WebSocket-Accept"] == tserver.accept_key(key)

    def send_frame(self, opcode: int, payload: bytes, fin: bool = True, mask: bool = True) -> None:
        n = len(payload)
        bit = 0x80 if mask else 0
        if n < 126:
            head = struct.pack(">BB", (0x80 if fin else 0) | opcode, bit | n)
        elif n < 1 << 16:
            head = struct.pack(">BBH", (0x80 if fin else 0) | opcode, bit | 126, n)
        else:
            head = struct.pack(">BBQ", (0x80 if fin else 0) | opcode, bit | 127, n)
        if mask:
            key = os.urandom(4)
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
            head += key
        self.sock.sendall(head + payload)

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    def recv_frame(self):
        """(opcode, payload, length field used: 7, 16 or 64)."""
        b0, b1 = self._exact(2)
        assert not b1 & 0x80  # the server does not mask
        n, bits = b1 & 0x7F, 7
        if n == 126:
            (n,), bits = struct.unpack(">H", self._exact(2)), 16
        elif n == 127:
            (n,), bits = struct.unpack(">Q", self._exact(8)), 64
        return b0 & 0x0F, self._exact(n), bits

    def recv_json(self, kind: str):
        while True:
            opcode, payload, bits = self.recv_frame()
            if opcode == 0x1 and json.loads(payload)["type"] == kind:
                return json.loads(payload), bits


def test_raw_client_frames_of_every_length(ray_viewer):
    """A raw client's masked camera messages of 70 kB (a 64-bit length) and
    1 kB (16-bit), one split into three fragments, a ping answered with its
    payload, a close echoed; the frames it receives are the port's renders
    (the scene payload took a 16-bit length, the frames too)."""
    v = ray_viewer
    c = RawClient(v.websocket_port)
    scene, bits = c.recv_json("scene")
    assert bits == 16 and len(scene["cameras"]) == NUM_IMAGES
    big = json.dumps(camera_message(2.5, fov=55.0, pad=70_000)).encode()
    assert len(big) > 1 << 16
    c.send_frame(0x1, big)
    frame, bits = c.recv_json("frame")
    assert bits == 16 and frame["fov"] == 55.0
    assert np.array_equal(decode_png(base64.b64decode(frame["image"])), expected_frame(v, frame))
    msg = json.dumps(camera_message(3.5, fov=65.0, pad=1000)).encode()
    c.send_frame(0x1, msg[:300], fin=False)
    c.send_frame(0x9, b"ping-in-between")
    c.send_frame(0x0, msg[300:700], fin=False)
    c.send_frame(0x0, msg[700:])
    while True:
        opcode, payload, _ = c.recv_frame()
        if opcode == 0xA:
            assert payload == b"ping-in-between"
            break
    while True:
        frame, _ = c.recv_json("frame")
        if frame["fov"] == 65.0:
            break
    assert np.array_equal(decode_png(base64.b64decode(frame["image"])), expected_frame(v, frame))
    c.send_frame(0x8, struct.pack(">H", 1000))
    while True:
        opcode, payload, _ = c.recv_frame()
        if opcode == 0x8:
            assert payload == struct.pack(">H", 1000)
            break
    c.sock.close()
    assert v.errors == []


def test_server_frame_lengths_and_accept_key():
    """The handshake's answer (RFC 6455 1.3's example) and the three length
    forms of a server frame, read back by the raw client's parser."""
    assert tserver.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    for n, bits in ((0, 7), (125, 7), (126, 16), (65535, 16), (65536, 64), (70_000, 64)):
        payload = bytes(range(256)) * (n // 256) + bytes(n % 256)
        a, b = socket.socketpair()
        sender = threading.Thread(target=a.sendall, args=(tserver.encode_frame(0x1, payload),))
        sender.start()
        try:
            client = RawClient.__new__(RawClient)
            client.sock = b
            assert client.recv_frame() == (0x1, payload, bits)
        finally:
            sender.join(timeout=10)
            a.close()
            b.close()


def test_unmasked_and_vanished_clients_leave_the_render_loop_serving(ray_viewer):
    """An unmasked client frame drops that client; a client that vanishes
    while frames stream to it is dropped; the render thread serves on and a
    new client gets frames."""
    v = ray_viewer
    c = RawClient(v.websocket_port)
    c.send_frame(0x1, json.dumps(camera_message()).encode(), mask=False)
    with pytest.raises((ConnectionError, OSError)):
        for _ in range(100):
            c.recv_frame()
    gone = RawClient(v.websocket_port)
    gone.send_frame(0x1, json.dumps(camera_message()).encode())
    gone.recv_json("frame")
    gone.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    gone.sock.close()  # a reset, mid-stream
    frames, _ = drive(v, [camera_message(3.2)], want_frames=2)
    assert len(frames) == 2 and v.errors == []


def test_splat_frames_crop_and_live_means(tmp_path):
    """A splat state with 300 slots, 100 of them alive: the scene payload
    carries the live means only; each frame is ``SplatfactoModel.render`` of
    its camera over the panel's background; the crop box masks the frame."""
    from nerfstudio_torch.pipelines.splat_pipeline import build_splat_pipeline

    scene = make_nerfstudio_fixture(tmp_path / "scene", n=4, hw=16)
    config = get_method("splatfacto")
    apply_overrides(config, ["--data", str(scene), "--machine.device_type", "cpu", "--model.max_gaussians", "300",
                             "--model.num_random", "100", "--model.random_init", "true"])
    pipeline, state = build_splat_pipeline(config)
    alive = state.aux.alive
    assert int(alive.sum()) == 100 and alive.numel() == 300
    v = start_viewer(pipeline, state, tmp_path / "out", max_resolution=24)
    try:
        frames, others = drive(v, [{"type": "setting", "updates": {"background_color": "#204060"}},
                                   camera_message(2.0)], want_frames=3)
        scene_msg = next(m for m in others if m["type"] == "scene")
        np.testing.assert_allclose(np.asarray(scene_msg["points"]), state.params["means"][alive].detach().numpy(),
                                   atol=1e-4)
        bg = torch.tensor([0x20, 0x40, 0x60], dtype=torch.float32) / 255
        for f in frames:
            pose = np.asarray(f["c2w"], np.float32).reshape(3, 4)
            cam = v.camera(pose, f["fov"], f["res"])
            focal = float(cam.fx[0, 0])
            want = pipeline.model.render(state.params, alive, cam.camera_to_worlds[0], (focal, focal, f["res"] / 2,
                                         f["res"] / 2), f["res"], f["res"], sh_degree_active=config.model.sh_degree,
                                         background=bg)
            got = decode_png(base64.b64decode(f["image"]))
            assert np.array_equal(got, tpanels.to_uint8(want["rgb"].detach().numpy()))
        drive(v, [{"type": "export", "kind": "gaussian-splat"}], want_frames=0, timeout=60,
              until=lambda: v.export_panel.status.startswith(("done", "error")))
        assert v.export_panel.status.startswith("done"), v.export_panel.status
        header = (tmp_path / "out" / "exports" / "splat.ply").read_bytes().split(b"end_header")[0].decode()
        assert "element vertex 100" in header
        v.control.apply({"crop_enabled": True, "crop_min": (5.0, 5.0, 5.0), "crop_max": (6.0, 6.0, 6.0)})
        empty = v.render_view(v.camera(np.asarray(frames[-1]["c2w"], np.float32).reshape(3, 4), 60.0, 24), 24)
        np.testing.assert_allclose(empty, np.broadcast_to(bg.numpy(), empty.shape), atol=1e-6)
        assert v.errors == []
    finally:
        v.stop()


# ---------------------------------------------------------------------------
# live training


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    return make_blender_fixture(tmp_path_factory.mktemp("blender"), n_train=4, n_val=1, hw=16)


def blender_trainer(scene, out, steps: int):
    """nerfacto at TINY on the Blender fixture (RGBA over white: the eval
    renders run under the white background override) on the CPU."""
    from nerfstudio_torch.pipelines.factory import build_trainer

    config = get_method("nerfacto")
    config.dataparser = get_dataparser_config("blender-data")
    rest = apply_overrides(config, ["--data", str(scene), "--machine.device_type", "cpu", "--trainer.vis", "none",
                                    *TINY, "--trainer.output_dir", str(out), "--trainer.max_num_iterations",
                                    str(steps), "--trainer.steps_per_save", "100", "--trainer.timestamp", "run",
                                    "--trainer.steps_per_eval_batch", "0", "--trainer.steps_per_eval_image", "0",
                                    "--trainer.steps_per_eval_all_images", "0"])
    assert not rest
    config.trainer.experiment_name = "blender"
    return build_trainer(config)


def test_live_viewing_leaves_training_bit_equal(blender_scene, tmp_path):
    """8 CPU steps of tiny nerfacto on the Blender scene, once with a viewer
    rendering while it steps (its client moving the camera, the panel's
    train_util at its floor, one pause and resume on the way) and once
    without: every step's loss and the final parameters and occupancy grid
    bit-equal. The viewer renders under the white eval background on its
    own thread and its own copy of the model, so neither its override nor
    its eval mode reaches a training step, and it draws no random number."""
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))  # the viewer's thread and the trainer's share the cores
    try:
        runs = {viewed: viewed_run(blender_scene, tmp_path, viewed) for viewed in (False, True)}
    finally:
        torch.set_num_threads(threads)
    (l0, p0, a0), (l1, p1, a1) = runs[False], runs[True]
    assert len(l0) == len(l1) == 8 and l0 == l1
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)
    for f in dataclasses.fields(a0):
        x, y = getattr(a0, f.name), getattr(a1, f.name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name


def viewed_run(blender_scene, tmp_path, viewed: bool):
    """(every step's loss, the final state dict, the final aux) of one run."""
    trainer = blender_trainer(blender_scene, tmp_path / f"viewed_{viewed}", 8)
    losses = []
    step_fn = trainer.train_iteration

    def recorded(step, step_fn=step_fn, losses=losses):
        metrics = step_fn(step)
        losses.append(float(metrics["loss"]))
        return metrics

    trainer.train_iteration = recorded
    if not viewed:
        trainer.train()
        return losses, trainer.pipeline.model.state_dict(), trainer.state.aux
    v = tserver.Viewer(trainer.pipeline, lambda: trainer.state, websocket_port=free_port(),
                       http_port=free_port(), max_resolution=16, train_lock=trainer.train_lock)
    v.output_dir = tmp_path / "viewer"
    v.control.apply({"train_util": 0.0})
    v.start()
    wait_for_port(v.websocket_port)
    trainer.viewer = v
    log = {"frames": [], "paused_at": None}

    def client():
        c = RawClient(v.websocket_port)
        for i in range(1000):
            c.send_frame(0x1, json.dumps(camera_message(2.5 + 0.1 * (i % 10))).encode())
            try:
                frame, _ = c.recv_json("frame")
            except (ConnectionError, OSError):
                return
            log["frames"].append(frame["step"])
            if len(log["frames"]) == 1:  # pause before the trainer's first step ends
                c.send_frame(0x1, json.dumps({"type": "setting", "updates": {"paused": True}}).encode())
                while not list((tmp_path / "viewed_True").rglob("step-*.ckpt")):  # the pause's save
                    time.sleep(0.05)
                log["paused_at"] = len(losses)
                time.sleep(0.5)
                log["held"] = len(losses) == log["paused_at"]
                c.send_frame(0x1, json.dumps({"type": "setting", "updates": {"paused": False}}).encode())

    th = threading.Thread(target=client, daemon=True)
    th.start()
    t0 = time.time()
    while not log["frames"] and time.time() - t0 < 60:
        time.sleep(0.05)
    assert log["frames"], "no frame before training"
    trainer.train()
    v.stop()
    th.join(timeout=30)
    assert not th.is_alive()
    assert log["held"] and 0 < log["paused_at"] < 8
    assert len(set(log["frames"])) >= 3  # frames at three or more of the training's steps
    assert v.errors == []
    return losses, trainer.pipeline.model.state_dict(), trainer.state.aux


def test_trainer_starts_the_viewer_with_vis_viewer(blender_scene, tmp_path, monkeypatch):
    """``--trainer.vis viewer`` starts a viewer on the trainer's lock and
    state, feeds it each step's stats, and stops it when training ends."""
    started = []
    cls = tserver.Viewer

    class FreePorts(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, websocket_port=free_port(), http_port=free_port(), **kwargs)
            started.append(self)

    monkeypatch.setattr(tserver, "Viewer", FreePorts)
    trainer = blender_trainer(blender_scene, tmp_path, 3)
    trainer.config.vis = "viewer"
    trainer.train()
    (v,) = started
    assert trainer.viewer is v and v.train_lock is trainer.train_lock and v.state_getter() is trainer.state
    assert v.stats["step"] == 2 and v.stats["loss"] == trainer.last_host_metrics["loss"]
    assert v._stop and not v._servers and not v._threads  # stopped with the run
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", v.websocket_port), timeout=1).close()
