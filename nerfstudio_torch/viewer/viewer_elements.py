"""User-API viewer widgets (counterpart of
``nerfstudio_tpu/viewer/viewer_elements.py``; reference
nerfstudio/viewer/viewer_elements.py:83-708).

Custom methods declare widgets as attributes on their model or pipeline
(``self.slider = ViewerSlider("noise", 0.1, 0, 1, cb_hook=...)``); the
viewer finds them at startup (``collect_viewer_elements``), ships their
specs to the browser client as a "Custom" panel, and routes the client's
updates back through ``handle`` to ``cb_hook``. Host code only:
``ViewerControl.get_camera`` builds the port's ``Cameras`` on the viewer's
device."""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


class ViewerElement(Generic[T]):
    """Base widget (reference viewer_elements.py:83-141)."""

    kind = "element"

    def __init__(self, name: str, disabled: bool = False, visible: bool = True,
                 cb_hook: Optional[Callable] = None):
        self.name = name
        self.disabled = disabled
        self.visible = visible
        self.cb_hook = cb_hook
        self._viewer = None

    # -- wiring --------------------------------------------------------------
    def install(self, viewer) -> None:
        """Register with a running Viewer (called by collect/register)."""
        self._viewer = viewer

    def to_spec(self) -> dict:
        return {
            "kind": self.kind,
            "name": self.name,
            "disabled": self.disabled,
            "visible": self.visible,
        }

    def handle(self, value) -> None:
        """Client update -> state change + callback."""
        if self.cb_hook is not None:
            self.cb_hook(self)

    def set_disabled(self, disabled: bool) -> None:
        self.disabled = disabled
        self._push()

    def set_visible(self, visible: bool) -> None:
        self.visible = visible
        self._push()

    def _push(self) -> None:
        if self._viewer is not None:
            self._viewer.push_custom_panel()


class ViewerButton(ViewerElement[bool]):
    """(reference viewer_elements.py:144-169)"""

    kind = "button"

    def handle(self, value) -> None:
        if self.cb_hook is not None:
            self.cb_hook(self)


class ViewerParameter(ViewerElement[T]):
    """Widget with a typed ``value`` (reference viewer_elements.py:196-245)."""

    def __init__(self, name: str, default_value: T, **kw):
        super().__init__(name, **kw)
        self._value: T = default_value

    @property
    def value(self) -> T:
        return self._value

    @value.setter
    def value(self, v: T) -> None:
        self._value = self._coerce(v)
        self._push()

    def _coerce(self, v):
        return v

    def to_spec(self) -> dict:
        spec = super().to_spec()
        spec["value"] = self._value
        return spec

    def handle(self, value) -> None:
        self._value = self._coerce(value)
        if self.cb_hook is not None:
            self.cb_hook(self)


class ViewerSlider(ViewerParameter[float]):
    """(reference viewer_elements.py:248-296)"""

    kind = "slider"

    def __init__(self, name: str, default_value: float, min_value: float,
                 max_value: float, step: float = 0.01, **kw):
        assert isinstance(default_value, (int, float))
        super().__init__(name, float(default_value), **kw)
        self.min = float(min_value)
        self.max = float(max_value)
        self.step = float(step)

    def _coerce(self, v):
        return float(np.clip(float(v), self.min, self.max))

    def to_spec(self) -> dict:
        return {**super().to_spec(), "min": self.min, "max": self.max, "step": self.step}


class ViewerNumber(ViewerParameter[float]):
    """(reference viewer_elements.py:299-326)"""

    kind = "number"

    def _coerce(self, v):
        return float(v)


class ViewerText(ViewerParameter[str]):
    """(reference viewer_elements.py:329-354)"""

    kind = "text"

    def _coerce(self, v):
        return str(v)


class ViewerCheckbox(ViewerParameter[bool]):
    """(reference viewer_elements.py:357-383)"""

    kind = "checkbox"

    def _coerce(self, v):
        return bool(v)


class ViewerDropdown(ViewerParameter[str]):
    """(reference viewer_elements.py:411-460)"""

    kind = "dropdown"

    def __init__(self, name: str, default_value: str, options: Sequence[str], **kw):
        assert default_value in options
        self.options: List[str] = list(options)
        super().__init__(name, default_value, **kw)

    def _coerce(self, v):
        v = str(v)
        return v if v in self.options else self._value

    def set_options(self, options: Sequence[str]) -> None:
        self.options = list(options)
        if self._value not in self.options and self.options:
            self._value = self.options[0]
        self._push()

    def to_spec(self) -> dict:
        return {**super().to_spec(), "options": self.options}


class ViewerButtonGroup(ViewerParameter[str]):
    """(reference viewer_elements.py:463-496)"""

    kind = "button_group"

    def __init__(self, name: str, default_value: str, options: Sequence[str], **kw):
        assert default_value in options
        self.options: List[str] = list(options)
        super().__init__(name, default_value, **kw)

    def _coerce(self, v):
        v = str(v)
        return v if v in self.options else self._value

    def to_spec(self) -> dict:
        return {**super().to_spec(), "options": self.options}


class ViewerRGB(ViewerParameter[Tuple[int, int, int]]):
    """(reference viewer_elements.py:499-528)"""

    kind = "rgb"

    def _coerce(self, v):
        r, g, b = (int(np.clip(int(x), 0, 255)) for x in v)
        return (r, g, b)

    def to_spec(self) -> dict:
        spec = super().to_spec()
        spec["value"] = list(self._value)
        return spec


class ViewerVec3(ViewerParameter[Tuple[float, float, float]]):
    """(reference viewer_elements.py:531-560)"""

    kind = "vec3"

    def __init__(self, name: str, default_value, step: float = 0.1, **kw):
        self.step = float(step)
        super().__init__(name, tuple(float(x) for x in default_value), **kw)

    def _coerce(self, v):
        x, y, z = (float(a) for a in v)
        return (x, y, z)

    def to_spec(self) -> dict:
        spec = super().to_spec()
        spec["value"] = list(self._value)
        spec["step"] = self.step
        return spec


class ViewerClick:
    """A click in the rendered view, lifted to a world-space ray
    (reference viewer_elements.py ViewerClick origin/direction)."""

    def __init__(self, origin, direction, screen_pos):
        self.origin = tuple(float(x) for x in origin)
        self.direction = tuple(float(x) for x in direction)
        self.screen_pos = tuple(float(x) for x in screen_pos)  # (x, y) in [0,1]


class ViewerRectSelect:
    """A rectangle selection in the rendered view (reference
    viewer_elements.py:69-80 ViewerRectSelect min/max bounds), with the
    world rays through both corners."""

    def __init__(self, min_pos, max_pos, ray_min=None, ray_max=None):
        self.min_pos = tuple(float(x) for x in min_pos)  # (u, v) in [0,1]
        self.max_pos = tuple(float(x) for x in max_pos)
        self.ray_min = ray_min  # (origin, direction) or None
        self.ray_max = ray_max


class ViewerControl:
    """Programmatic camera/scene control for custom methods
    (reference viewer_elements.py:563-708: set_pose, set_fov, set_crop,
    get_camera, register_click_cb)."""

    def __init__(self):
        self._viewer = None
        self._click_cbs: List[Callable[[ViewerClick], None]] = []
        self._rect_cbs: List[Callable[[ViewerRectSelect], None]] = []
        self._lock = threading.Lock()

    def install(self, viewer) -> None:
        self._viewer = viewer

    # -- camera --------------------------------------------------------------
    def set_pose(self, position=None, look_at=None, instant: bool = True) -> None:
        """Push a camera pose to connected clients (reference :601-627)."""
        if self._viewer is None:
            return
        payload = {"type": "set_camera", "instant": bool(instant)}
        if position is not None:
            payload["position"] = [float(x) for x in position]
        if look_at is not None:
            payload["look_at"] = [float(x) for x in look_at]
        self._viewer._send(payload)

    def set_fov(self, fov: float) -> None:
        if self._viewer is not None:
            self._viewer._send({"type": "set_camera", "fov": float(fov)})

    def set_crop(self, min_point, max_point) -> None:
        """(reference :629-644) — drives the control panel's crop box."""
        if self._viewer is not None:
            self._viewer.control.apply(
                {
                    "crop_enabled": True,
                    "crop_min": tuple(float(x) for x in min_point),
                    "crop_max": tuple(float(x) for x in max_point),
                }
            )

    def get_camera(self, img_height: int, img_width: int):
        """Current viewer camera as a Cameras object on the viewer's device
        (reference :657-680)."""
        if self._viewer is None or self._viewer.camera_pose is None:
            return None
        from nerfstudio_torch.cameras.cameras import Cameras

        fov = self._viewer.camera_fov
        focal = img_height / (2.0 * np.tan(np.deg2rad(fov) / 2.0))
        return Cameras.create(
            np.asarray(self._viewer.camera_pose, np.float32)[None],
            fx=focal, fy=focal, cx=img_width / 2.0, cy=img_height / 2.0,
            width=img_width, height=img_height, device=self._viewer.device,
        )

    # -- clicks ---------------------------------------------------------------
    def register_click_cb(self, cb: Callable[[ViewerClick], None]) -> None:
        with self._lock:
            self._click_cbs.append(cb)

    def unregister_click_cb(self, cb: Callable[[ViewerClick], None]) -> None:
        with self._lock:
            if cb in self._click_cbs:
                self._click_cbs.remove(cb)

    # -- rectangle select -------------------------------------------------------
    def register_rect_cb(self, cb: "Callable[[ViewerRectSelect], None]") -> None:
        """(reference viewer_elements.py ViewerRectSelect + register_pointer_cb)"""
        with self._lock:
            self._rect_cbs.append(cb)

    def unregister_rect_cb(self, cb) -> None:
        with self._lock:
            if cb in self._rect_cbs:
                self._rect_cbs.remove(cb)

    def on_rect(self, u0: float, v0: float, u1: float, v1: float):
        """Client rectangle select (alt-drag): corners in normalized screen
        coords, lifted to world rays at the two corners."""
        if self._viewer is None or self._viewer.camera_pose is None:
            return None
        a = self.on_ray(u0, v0)
        b = self.on_ray(u1, v1)
        rect = ViewerRectSelect((u0, v0), (u1, v1), a, b)
        with self._lock:
            cbs = list(self._rect_cbs)
        for cb in cbs:
            cb(rect)
        return rect

    def on_ray(self, u: float, v: float):
        """(origin, direction) world ray through normalized (u, v)."""
        c2w = np.asarray(self._viewer.camera_pose, np.float32)
        half = np.tan(np.deg2rad(self._viewer.camera_fov) / 2.0)
        d_cam = np.array([(2 * u - 1) * half, (1 - 2 * v) * half, -1.0], np.float32)
        d_world = c2w[:3, :3] @ d_cam
        return c2w[:3, 3], d_world / np.linalg.norm(d_world)

    def on_click(self, u: float, v: float) -> Optional[ViewerClick]:
        """Client click at normalized (u,v) -> world ray -> callbacks."""
        if self._viewer is None or self._viewer.camera_pose is None:
            return None
        c2w = np.asarray(self._viewer.camera_pose, np.float32)
        fov = self._viewer.camera_fov
        half = np.tan(np.deg2rad(fov) / 2.0)
        # OpenGL camera: x right, y up, looking down -z
        d_cam = np.array(
            [(2 * u - 1) * half, (1 - 2 * v) * half, -1.0], np.float32
        )
        d_world = c2w[:3, :3] @ d_cam
        d_world = d_world / np.linalg.norm(d_world)
        click = ViewerClick(c2w[:3, 3], d_world, (u, v))
        with self._lock:
            cbs = list(self._click_cbs)
        for cb in cbs:
            cb(click)
        return click


def collect_viewer_elements(*roots, max_depth: int = 3) -> List[Tuple[str, Any]]:
    """Recursively scan objects (model, pipeline, nested fields/components...)
    for ViewerElement / ViewerControl attributes, returning
    (qualified_name, element) pairs (reference viewer.py:268 parse_object).

    Recursion is bounded by ``max_depth`` and a visited set; containers
    (list/tuple/dict) are traversed one level so element lists register too."""
    found: List[Tuple[str, Any]] = []
    seen: set = set()
    visited: set = set()

    def _scan(obj: Any, prefix: str, depth: int) -> None:
        if obj is None or id(obj) in visited or depth > max_depth:
            return
        visited.add(id(obj))
        attrs = getattr(obj, "__dict__", None)
        if not isinstance(attrs, dict):
            return
        for attr_name, val in attrs.items():
            if attr_name.startswith("__"):
                continue
            name = f"{prefix}.{attr_name}" if prefix else attr_name
            candidates: List[Tuple[str, Any]] = [(name, val)]
            if isinstance(val, (list, tuple)):
                candidates = [(f"{name}[{i}]", v) for i, v in enumerate(val)]
            elif isinstance(val, dict):
                candidates = [(f"{name}[{k}]", v) for k, v in val.items()]
            for cname, cval in candidates:
                if isinstance(cval, (ViewerElement, ViewerControl)):
                    if id(cval) not in seen:
                        seen.add(id(cval))
                        found.append((cname, cval))
                elif depth < max_depth and hasattr(cval, "__dict__"):
                    # skip obvious non-containers to bound the walk
                    mod = type(cval).__module__ or ""
                    if not mod.startswith(("torch", "numpy", "builtins")):
                        _scan(cval, cname, depth + 1)

    for root in roots:
        if root is not None:
            _scan(root, type(root).__name__, 0)
    return found
