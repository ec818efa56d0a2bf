"""Live web viewer (counterpart of ``nerfstudio_tpu/viewer/server.py``;
reference nerfstudio/viewer/).

A browser client (``viewer/client.html``, served over HTTP on
``http_port``) orbits a camera and streams frames from a websocket on
``websocket_port``. Both servers are the standard library's: the websocket
is RFC 6455 written here over ``http.server`` (the handshake, text frames
with 7-, 16- and 64-bit lengths, the client's masks, ping/pong and close),
since the card's machine promises no ``websockets`` package. Frames travel
as PNG (``data/image_io.encode_png``), which needs no Pillow either.

The render loop follows the reference's RenderStateMachine
(viewer/render_state_machine.py:55-353): a 128^2 preview while the camera
moves, 256^2 when it stops (neither above ``max_resolution``), then
``max_resolution`` rendered exactly, and a
sleep after each frame that leaves the device to training. The previews
run the field's stochastic trilerp (K1) at eval; the high frame the exact
one (K3).

Rendering never touches the training model: under the trainer's
``train_lock`` the viewer copies the parameters into its own eval-mode copy
of the model (a splat state's gaussians are cloned) and clones the
auxiliary state, then renders from those on its own thread. The eval
background override is per thread (``model_components/renderers.py``), and
an eval render draws no random numbers."""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import hashlib
import http.server
import json
import socket
import struct
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerfstudio_torch.models.base_model import module_twin

# the PNG frames' zlib level: level 1 encodes a 512^2 frame in a few ms on
# the host, levels 6-9 take several times longer for ~10% fewer bytes
FRAME_PNG_LEVEL = 1

# RFC 6455
_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_TEXT, _BINARY, _CONTINUATION, _CLOSE, _PING, _PONG = 0x1, 0x2, 0x0, 0x8, 0x9, 0xA
_MAX_MESSAGE = 1 << 24  # the largest client message taken; a camera message is ~300 bytes
_SEND_TIMEOUT = 10.0  # seconds a client may stall a send before it is dropped


def accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` answer to a client's ``Sec-WebSocket-Key``:
    base64 of the SHA-1 of the key and the protocol's GUID (RFC 6455 4.2.2)."""
    return base64.b64encode(hashlib.sha1((key + _GUID).encode()).digest()).decode()


def encode_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked, final server frame (RFC 6455 5.2): the length in 7 bits,
    in 16 after 126, or in 64 after 127."""
    n = len(payload)
    if n < 126:
        head = struct.pack(">BB", 0x80 | opcode, n)
    elif n < 1 << 16:
        head = struct.pack(">BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack(">BBQ", 0x80 | opcode, 127, n)
    return head + payload


def unmask(payload: bytes, mask: bytes) -> bytes:
    """A client frame's payload XORed with its 4-byte mask, repeated."""
    data = np.frombuffer(payload, np.uint8)
    return (data ^ np.resize(np.frombuffer(mask, np.uint8), data.shape)).tobytes()


class ProtocolError(ValueError):
    """A client frame the protocol forbids (unmasked, oversized, unknown)."""


class WebSocketConnection:
    """One client after the handshake. The client's frames are read on the
    connection's own thread; writes come from the render thread and from the
    message handlers, so each frame is written whole under a lock."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sock.settimeout(_SEND_TIMEOUT)
        self._write_lock = threading.Lock()
        self.closed = False

    def send_text(self, text: str) -> None:
        self._send(_TEXT, text.encode())

    def _send(self, opcode: int, payload: bytes) -> None:
        frame = encode_frame(opcode, payload)
        with self._write_lock:
            self.sock.sendall(frame)

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(min(n - len(buf), 1 << 20))
            except socket.timeout:  # an idle client: a receive that timed out took no bytes
                if self.closed:
                    raise ConnectionError("connection closed") from None
                continue
            if not chunk:
                raise ConnectionError("the client closed the connection")
            buf += chunk
        return bytes(buf)

    def recv_message(self) -> Optional[bytes]:
        """The next text or binary message's payload, its fragments joined,
        answering pings on the way; None after the client's close frame,
        which is answered."""
        parts, kind = [], None
        while True:
            b0, b1 = self._read_exact(2)
            fin, opcode = b0 & 0x80, b0 & 0x0F
            if not b1 & 0x80:
                raise ProtocolError("a client frame without a mask")
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", self._read_exact(2))
            elif n == 127:
                (n,) = struct.unpack(">Q", self._read_exact(8))
            if n > _MAX_MESSAGE:
                raise ProtocolError(f"a client frame of {n} bytes")
            mask = self._read_exact(4)
            payload = unmask(self._read_exact(n), mask)
            if opcode == _CLOSE:
                self._send(_CLOSE, payload[:2])
                return None
            if opcode == _PING:
                self._send(_PONG, payload)
            elif opcode == _PONG:
                pass
            elif opcode in (_TEXT, _BINARY):
                parts, kind = [payload], opcode
            elif opcode == _CONTINUATION and kind is not None:
                parts.append(payload)
            else:
                raise ProtocolError(f"client frame with opcode {opcode:#x}")
            if fin and kind is not None and opcode in (_TEXT, _BINARY, _CONTINUATION):
                message = b"".join(parts)
                if sum(map(len, parts)) > _MAX_MESSAGE:
                    raise ProtocolError("a client message over the limit")
                return message

    def close(self) -> None:
        self.closed = True
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()


class RenderState:
    LOW_MOVE = "low_move"
    LOW_STATIC = "low_static"
    HIGH = "high"


class Viewer:
    """(reference viewer/viewer.py:57-530). ``state_getter()`` returns the
    train state to render (a ``TrainState`` of a ray pipeline, whose
    parameters are the pipeline's model's, or a ``SplatTrainState``);
    ``train_lock`` is the trainer's, held while the viewer copies it."""

    def __init__(
        self,
        pipeline,
        state_getter,
        websocket_port: int = 7007,
        http_port: int = 7008,
        max_resolution: int = 512,
        train_lock=None,
    ):
        from nerfstudio_torch.viewer.panels import ControlPanelState, ExportPanel, RenderPanel
        from nerfstudio_torch.viewer.viewer_elements import ViewerControl, collect_viewer_elements

        self.pipeline = pipeline
        self.state_getter = state_getter
        self.train_lock = train_lock
        self.websocket_port = websocket_port
        self.http_port = http_port
        # a splat pipeline's model renders a state's gaussians; a ray
        # pipeline's model holds the parameters
        self.splat = not isinstance(pipeline.model, torch.nn.Module)
        self.device = pipeline.datamanager.train_images.device if self.splat else pipeline.device
        self.camera_pose: Optional[np.ndarray] = None
        self.camera_fov: float = 60.0
        self.render_state = RenderState.LOW_STATIC
        self._dirty = threading.Event()
        self._clients = set()
        self._clients_lock = threading.Lock()
        # held by each render (and by an export for its whole run): one
        # snapshot and render of the viewer's model at a time
        self.render_lock = threading.RLock()
        self._shadow = None  # (eval pipeline) of a ray pipeline
        self._servers = []
        self._threads = []
        self._stop = False
        self.errors = []  # every render error, printed as it happens
        self.stats = {"step": 0, "rays_per_sec": 0.0}
        self._last_stats_ts = 0.0
        self._snapshot_requested = False
        self._snap_status = ""
        self.control = ControlPanelState(max_resolution=max_resolution)
        self.render_panel = RenderPanel()
        self.export_panel = ExportPanel()
        self.output_dir = Path("viewer_outputs")
        # user-API widgets declared by the method (reference viewer_elements.py)
        self.custom_elements = {}
        self.viewer_controls = []
        for qual_name, elem in collect_viewer_elements(pipeline, getattr(pipeline, "model", None)):
            elem.install(self)
            if isinstance(elem, ViewerControl):
                self.viewer_controls.append(elem)
            else:
                self.custom_elements[qual_name] = elem

    @property
    def paused(self) -> bool:
        return self.control.paused

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Bind both ports (here, so that a port in use raises to the caller),
        then serve them and render on daemon threads until ``stop``."""
        viewer = self
        client_html = (Path(__file__).parent / "client.html").read_text(encoding="utf-8")
        page = client_html.replace("__WS_PORT__", str(self.websocket_port)).encode()

        class WebSocketHandler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            rbufsize = 0  # nothing of the client's first frame may stay in a read buffer

            def do_GET(self):
                key = self.headers.get("Sec-WebSocket-Key")
                if self.headers.get("Upgrade", "").lower() != "websocket" or not key:
                    self.send_error(400, "a websocket upgrade request is expected here")
                    return
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept_key(key))
                self.end_headers()
                self.close_connection = True
                viewer._serve_client(WebSocketConnection(self.connection))

            def log_message(self, *args):
                pass

        class PageHandler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)

            def log_message(self, *args):
                pass

        for port, handler in ((self.websocket_port, WebSocketHandler), (self.http_port, PageHandler)):
            server = http.server.ThreadingHTTPServer(("0.0.0.0", port), handler)
            self._servers.append(server)
            self._threads.append(threading.Thread(target=server.serve_forever, daemon=True))
        self._threads.append(threading.Thread(target=self._render_loop, daemon=True))
        for t in self._threads:
            t.start()
        print(f"viewer running: http://localhost:{self.http_port} (ws: {self.websocket_port})", flush=True)

    def stop(self) -> None:
        """Stop rendering, close every client and both servers, and join the
        threads."""
        self._stop = True
        with self._clients_lock:
            clients, self._clients = list(self._clients), set()
        for conn in clients:
            conn.close()
        for server in self._servers:
            server.shutdown()
            server.server_close()
        for t in self._threads:
            t.join(timeout=30)
        self._servers, self._threads = [], []

    def update(self, trainer, step: int) -> None:
        """Called by the trainer each iteration (reference trainer.py:374)."""
        self.stats["step"] = step
        m = getattr(trainer, "last_host_metrics", None)
        if m:
            self.stats["loss"] = m.get("loss")
            self.stats["rays_per_sec"] = m.get("train_rays_per_sec", 0.0)
            if "num_alive" in m:
                self.stats["num_gaussians"] = m["num_alive"]
        now = time.time()
        if self._clients and now - self._last_stats_ts > 1.0:
            self._last_stats_ts = now
            self._send({"type": "stats", **{k: v for k, v in self.stats.items() if v is not None}})

    # -- websocket clients ------------------------------------------------
    def _serve_client(self, conn: WebSocketConnection) -> None:
        with self._clients_lock:
            self._clients.add(conn)
        try:
            if self.custom_elements:
                conn.send_text(json.dumps(self._custom_panel_payload()))
            scene = self._scene_payload()
            if scene is not None:
                conn.send_text(json.dumps(scene))
            while not self._stop:
                raw = conn.recv_message()
                if raw is None:
                    break
                self._handle(json.loads(raw))
        except (OSError, ValueError) as e:  # a vanished client, or one that broke the protocol
            if not self._stop and not conn.closed:
                print(f"[viewer] client dropped: {e!r}", flush=True)
        finally:
            with self._clients_lock:
                self._clients.discard(conn)
            conn.close()

    def _handle(self, msg: dict) -> None:
        """One client message (the reference's panel and camera callbacks)."""
        mtype = msg.get("type")
        if mtype == "camera":
            self.camera_pose = np.asarray(msg["c2w"], np.float32).reshape(3, 4)
            self.camera_fov = float(msg.get("fov", 60.0))
            self.render_state = RenderState.LOW_MOVE
            self._dirty.set()
        elif mtype == "setting":
            # control panel update (reference control_panel.py)
            self.control.apply(msg.get("updates", {}))
            self.render_state = RenderState.LOW_STATIC
            self._dirty.set()
        elif mtype == "keyframe_add":
            if self.camera_pose is not None:
                n = self.render_panel.add_keyframe(self.camera_pose, self.camera_fov)
                self._send({"type": "panel", "keyframes": n})
        elif mtype == "keyframe_clear":
            self.render_panel.clear()
            self._send({"type": "panel", "keyframes": 0})
        elif mtype == "keyframe_delete":
            n = self.render_panel.delete(int(msg.get("index", -1)))
            self._send({"type": "panel", "keyframes": n})
        elif mtype == "keyframe_fov":
            self.render_panel.set_keyframe_fov(int(msg.get("index", -1)), float(msg.get("fov", 60.0)))
        elif mtype == "loop":
            self.render_panel.loop = bool(msg.get("enabled", False))
        elif mtype == "path_load":
            try:
                # only paths inside output_dir: the socket is unauthenticated,
                # so a client's filesystem path would be an arbitrary-file probe
                p = (Path(self.output_dir) / Path(msg.get("path", "camera_path.json")).name).resolve()
                n = self.render_panel.load_path_json(p)
                self.render_panel.status = f"loaded {n} keyframes"
                self._send({"type": "panel", "keyframes": n})
            except (OSError, ValueError, KeyError) as e:
                self.render_panel.status = f"error: {e}"
        elif mtype == "path_save":
            try:
                p = self.render_panel.save_path_json(
                    self.output_dir / "camera_path.json",
                    resolution=int(msg.get("resolution", 512)),
                    fps=int(msg.get("fps", 24)),
                    seconds=float(msg.get("seconds", 4.0)),
                )
                self.render_panel.status = f"saved: {p}"
            except (OSError, ValueError, AssertionError) as e:
                self.render_panel.status = f"error: {e}"
        elif mtype == "snapshot":
            self._snapshot_requested = True
            self._dirty.set()
        elif mtype == "render_path":
            self.render_panel.render_path_async(self, int(msg.get("frames", 48)), int(msg.get("resolution", 512)),
                                                self.output_dir / "render")
        elif mtype == "export":
            self.export_panel.export_async(self, msg.get("kind", "pointcloud"), self.output_dir / "exports",
                                           num_points=int(msg.get("num_points", 200000)))
        elif mtype == "custom":
            # user-API widget update (reference viewer_elements cb_hook)
            elem = self.custom_elements.get(msg.get("id") or msg.get("name"))
            if elem is not None:
                try:
                    elem.handle(msg.get("value"))
                except Exception as e:  # noqa: BLE001 — a method's callback; the viewer serves on
                    print(f"[viewer] widget {msg.get('id')}: {e!r}", flush=True)
                self.render_state = RenderState.LOW_STATIC
                self._dirty.set()
        elif mtype == "click":
            for vc in self.viewer_controls:
                try:
                    vc.on_click(float(msg.get("u", 0.5)), float(msg.get("v", 0.5)))
                except Exception as e:  # noqa: BLE001 — a method's callback
                    print(f"[viewer] click cb: {e!r}", flush=True)
        elif mtype == "rect":
            # alt-drag rectangle select (reference ViewerRectSelect)
            for vc in self.viewer_controls:
                try:
                    vc.on_rect(float(msg.get("u0", 0.0)), float(msg.get("v0", 0.0)),
                               float(msg.get("u1", 1.0)), float(msg.get("v1", 1.0)))
                except Exception as e:  # noqa: BLE001 — a method's callback
                    print(f"[viewer] rect cb: {e!r}", flush=True)

    def _custom_panel_payload(self) -> dict:
        return {
            "type": "custom_panel",
            "elements": [{**el.to_spec(), "id": name} for name, el in self.custom_elements.items()],
        }

    def _scene_payload(self, max_points: int = 2000) -> Optional[dict]:
        """The static 3D scene the client draws over the frame at input
        rate: the training cameras' c2w rows and a subsample of points (a
        splat state's live means, or the capture's SfM points). The
        reference draws these in viser's three.js scene (viewer.py:432)."""
        dm = self.pipeline.datamanager
        cams = getattr(dm, "train_cameras", None)
        if cams is None:
            return None
        c2ws = cams.camera_to_worlds.detach().cpu().numpy().reshape(-1, 3, 4)
        payload = {"type": "scene", "cameras": np.round(c2ws, 4).reshape(len(c2ws), 12).tolist()}
        pts = None
        if self.splat:
            with self.train_lock or contextlib.nullcontext():
                state = self.state_getter()
                pts = state.params["means"].detach()[state.aux.alive].cpu().numpy()
        else:
            md = getattr(getattr(dm, "train_dataset", None), "metadata", None) or {}
            if md.get("points3D_xyz") is not None:
                pts = np.asarray(md["points3D_xyz"], np.float32)
        if pts is not None and len(pts):
            if len(pts) > max_points:
                pts = pts[:: len(pts) // max_points + 1]
            payload["points"] = np.round(pts, 4).tolist()
        return payload

    def push_custom_panel(self) -> None:
        """Re-broadcast widget specs after a host-side state change
        (reference viewer_elements set_disabled/set_options)."""
        if self.custom_elements:
            self._send(self._custom_panel_payload())

    def _send(self, payload: dict) -> None:
        """Broadcast to every client; a client whose send fails is dropped."""
        data = json.dumps(payload)
        with self._clients_lock:
            clients = list(self._clients)
        for conn in clients:
            try:
                conn.send_text(data)
            except OSError:
                with self._clients_lock:
                    self._clients.discard(conn)
                conn.close()

    # -- the state a render reads ------------------------------------------
    def snapshot(self):
        """(pipeline, state) to render from, taken under the train lock: for
        a ray pipeline a shallow copy of it whose model is the viewer's own
        eval copy, its parameters copied from the training model's, and the
        auxiliary state cloned; for a splat pipeline the pipeline and a clone
        of the gaussians and their alive mask. Neither reads a generator."""
        from nerfstudio_torch.pipelines.base_pipeline import TrainState

        with self.train_lock or contextlib.nullcontext():
            state = self.state_getter()
            if self.splat:
                from nerfstudio_torch.pipelines.splat_pipeline import SplatTrainState

                params = {k: v.detach().clone() for k, v in state.params.items()}
                aux = dataclasses.replace(state.aux, alive=state.aux.alive.clone())
                return self.pipeline, SplatTrainState(params, None, aux, int(state.step))
            pipeline = self._eval_pipeline()
            aux = state.aux
            if aux is not None:
                aux = dataclasses.replace(aux, **{f.name: getattr(aux, f.name).clone() for f in dataclasses.fields(aux)
                                                  if isinstance(getattr(aux, f.name), torch.Tensor)})
            return pipeline, TrainState(optimizer=None, step=int(state.step), aux=aux)

    @torch.no_grad()
    def _eval_pipeline(self):
        """The viewer's pipeline with the training model's parameters copied
        into its eval copy; the copy is made anew where the parameters'
        names or shapes changed (tensorf's grid upsample)."""
        live = self.pipeline.model.state_dict()
        shadow = None if self._shadow is None else self._shadow.model.state_dict()
        if shadow is None or shadow.keys() != live.keys() or any(
                shadow[k].shape != v.shape for k, v in live.items()):
            pipeline = copy.copy(self.pipeline)
            pipeline.model = module_twin(self.pipeline.model, clone_tensors=True).eval()
            self._shadow = pipeline
            return pipeline
        for k, v in live.items():
            shadow[k].copy_(v)
        return self._shadow

    # -- rendering -----------------------------------------------------------
    def camera(self, c2w, fov: float, res: int):
        """A res x res pinhole at ``c2w`` (3, 4) with vertical ``fov`` degrees,
        on the CPU (the pipelines move it where they render)."""
        from nerfstudio_torch.cameras.cameras import Cameras

        focal = res / (2 * np.tan(np.deg2rad(fov) / 2))
        return Cameras.create(np.asarray(c2w, np.float32)[None], fx=focal, fy=focal, cx=res / 2, cy=res / 2,
                              width=res, height=res, device="cpu")

    def _resolution_for_state(self) -> int:
        """128 while moving, 256 when still, then ``max_resolution``; no
        preview above ``max_resolution``."""
        top = self.control.max_resolution
        if self.render_state == RenderState.LOW_MOVE:
            return min(128, top)
        if self.render_state == RenderState.LOW_STATIC:
            return min(256, top)
        return top

    @torch.no_grad()
    def render_view(self, cam, res: int, preview: bool = False) -> np.ndarray:
        """Render one camera -> (res, res, 3) float32 rgb in [0, 1] on the
        host, under the control panel's output, colormap, crop, background
        and time settings (reference control_panel.py)."""
        from nerfstudio_torch.utils.colormaps import apply_colormap, apply_depth_colormap

        with self.render_lock:
            pipeline, state = self.snapshot()
            ctl = self.control
            if self.splat:
                alive = state.aux.alive
                if ctl.crop_enabled:
                    # crop the splat scene to the box (reference splatfacto crop_box)
                    means = state.params["means"]
                    lo = torch.tensor(ctl.crop_min, dtype=means.dtype, device=means.device)
                    hi = torch.tensor(ctl.crop_max, dtype=means.dtype, device=means.device)
                    alive = alive & torch.all((means >= lo) & (means <= hi), dim=-1)
                focal = float(cam.fx[0, 0])
                out = pipeline.model.render(
                    state.params, alive, cam.camera_to_worlds[0].cpu(), (focal, focal, res / 2, res / 2), res, res,
                    sh_degree_active=pipeline.model.config.sh_degree,
                    background=torch.tensor(ctl.background_rgb(), dtype=torch.float32, device=self.device))
            else:
                if getattr(pipeline.datamanager.train_cameras, "times", None) is not None:
                    # a dynamic scene at the time slider's time (reference :370-377)
                    cam = dataclasses.replace(cam, times=torch.full((len(cam), 1), float(ctl.time)))
                # one chunk for a frame within the model's chunk (the
                # reference's res^2), so a small frame is not padded to it
                chunk = min(res * res, pipeline.model.config.eval_num_rays_per_chunk)
                out = pipeline.render_camera(state, cam, 0, chunk, preview=preview)
            sel = ctl.output_type
            if sel == "depth" and "depth" in out:
                d = out["depth"]
                d = d[..., None] if d.ndim == 2 else d
                if ctl.invert_colormap:
                    d = -d
                acc = out.get("accumulation")
                if acc is not None and acc.ndim == 2:
                    acc = acc[..., None]
                rgb = apply_depth_colormap(d, accumulation=acc, near_plane=ctl.depth_near,
                                           far_plane=ctl.colormap_max, colormap=ctl.colormap)
            elif sel == "accumulation" and "accumulation" in out:
                a = out["accumulation"]
                rgb = apply_colormap(a[..., None] if a.ndim == 2 else a, colormap=ctl.colormap)
            else:
                rgb = out["rgb"]
            return rgb.float().cpu().numpy()

    def _render_loop(self) -> None:
        from nerfstudio_torch.data.image_io import encode_png, write_png
        from nerfstudio_torch.viewer.panels import draw_camera_frustums, to_uint8

        while not self._stop:
            if not self._clients or self.camera_pose is None:
                time.sleep(0.1)
                continue
            self._dirty.clear()
            preview = self.render_state != RenderState.HIGH
            res = self._resolution_for_state()
            pose, fov = self.camera_pose, self.camera_fov
            try:
                t0 = time.perf_counter()
                # the stochastic-trilerp preview while moving and refining;
                # the final HIGH pass renders exactly
                rgb = self.render_view(self.camera(pose, fov, res), res, preview=preview)
                dt = time.perf_counter() - t0  # render_view ends in a copy to the host
                frame = to_uint8(rgb)
                if self.control.show_cameras:
                    focal = res / (2 * np.tan(np.deg2rad(fov) / 2))
                    train_c2ws = self.pipeline.datamanager.train_cameras.camera_to_worlds[:50].cpu().numpy()
                    frame = draw_camera_frustums(frame, pose, focal, train_c2ws)
                if self._snapshot_requested:
                    self._snapshot_requested = False
                    snap_dir = self.output_dir / "snapshots"
                    snap_dir.mkdir(parents=True, exist_ok=True)
                    p = snap_dir / f"snapshot_{int(time.time())}_{self.stats['step']}.png"
                    write_png(p, frame)
                    self._snap_status = f"saved {p.name}"
                t1 = time.perf_counter()
                png = encode_png(frame, FRAME_PNG_LEVEL)
                encode_s = time.perf_counter() - t1
                self._send({
                    "type": "frame",
                    "image": base64.b64encode(png).decode(),
                    "res": res,
                    "preview": preview,
                    "c2w": np.asarray(pose, np.float32).reshape(-1).tolist(),
                    "fov": fov,
                    "render_ms": dt * 1e3,
                    "encode_ms": encode_s * 1e3,
                    "step": self.stats["step"],
                    "render_status": self.render_panel.status,
                    "export_status": self.export_panel.status,
                    "snap_status": self._snap_status,
                    "paused": self.control.paused,
                })
                # progressive refinement: move -> static -> high
                if not self._dirty.is_set():
                    if self.render_state == RenderState.LOW_MOVE:
                        self.render_state = RenderState.LOW_STATIC
                    elif self.render_state == RenderState.LOW_STATIC:
                        self.render_state = RenderState.HIGH
                # yield to training
                util = min(max(self.control.train_util, 0.05), 0.98)
                time.sleep(max(dt * util / (1 - util), 0.02))
            except Exception as e:  # noqa: BLE001 — the loop serves on; the error is printed and kept
                print(f"[viewer] render error: {e!r}", flush=True)
                self.errors.append(repr(e))
                time.sleep(0.5)
