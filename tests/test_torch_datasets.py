"""The port's image decoder and ``InputDataset`` against Pillow and the JAX
package's ``InputDataset``: PNG of colour types 0, 2, 4 and 6 byte-equal to
Pillow's decode, from Pillow's own encoder, from the synthetic tool and
from rows written with each of the five filters; JPEG through Pillow; the
float images and their alpha blending equal to JAX's."""

import json
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from _torch_port import make_synthetic_scene
from fixtures import make_blender_fixture, make_nerfstudio_fixture
from nerfstudio_tpu.data.dataparsers.blender_dataparser import BlenderDataParserConfig as JBlender
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_tpu.data.datasets import InputDataset as JInputDataset
from nerfstudio_torch.data import image_io
from nerfstudio_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.data.datasets import InputDataset

MODES = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _image(rng, h, w, c):
    """A smooth gradient plus noise, so every filter has work to do."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 3)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 12, (h, w, c))) % 256).astype(np.uint8)


def _pillow(path):
    arr = np.asarray(Image.open(path))
    return arr[..., None] if arr.ndim == 2 else arr


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, img, filters):
    """A PNG whose row y is written with filter ``filters[y % len]``."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = ([np.zeros_like(cur), left, up, (left + up) // 2, _paeth(left, up, upleft)] + [0] * 251)[kind]
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", sorted(MODES))
def test_png_from_pillow_decodes_as_pillow_does(tmp_path, ctype):
    """Pillow's encoder picks a filter per row (it uses several here)."""
    img = _image(np.random.default_rng(ctype), 23, 37, CHANNELS[ctype])
    path = tmp_path / "a.png"
    Image.fromarray(img[..., 0] if ctype == 0 else img, MODES[ctype]).save(path)
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and np.array_equal(got, _pillow(path)) and np.array_equal(got, img)
    assert image_io.image_size(path) == (37, 23)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("ctype", sorted(MODES))
def test_png_row_filters_decode_as_pillow_does(tmp_path, ctype, filters):
    img = _image(np.random.default_rng(10 + ctype), 17, 29, CHANNELS[ctype])
    path = tmp_path / "f.png"
    _write_png(path, img, filters)
    assert np.array_equal(_pillow(path), img)  # the test's own encoder is right
    assert np.array_equal(image_io.read_image(path), img)


def test_unknown_png_row_filter_raises(tmp_path):
    img = _image(np.random.default_rng(4), 5, 7, 3)
    _write_png(tmp_path / "bad.png", img, (1, 2, 7))
    with pytest.raises(ValueError, match="unknown PNG row filter 7 on row 2"):
        image_io.read_image(tmp_path / "bad.png")


def test_png_decode_time_reports_every_image(tmp_path, capsys):
    """The decode-time script writes Pillow PNGs (noise-free and noisy
    frames), decodes each as Pillow does and reports it."""
    from nerfstudio_torch.scripts import png_decode_time

    summary = png_decode_time.main([str(tmp_path), "--write", "2", "24x40"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert summary["images"] == 2 and len(lines) == 3 and lines[-1] == summary
    for rec in lines[:2]:
        assert rec["shape"] == [24, 40, 3] and sum(rec["row_filters"].values()) == 24 and rec["ms"] > 0
        assert np.array_equal(image_io.read_image(tmp_path / rec["file"]), _pillow(tmp_path / rec["file"]))


def test_synthetic_tool_png_decodes_as_pillow_does(tmp_path):
    scene = make_synthetic_scene(tmp_path / "synthetic")
    paths = sorted((scene / "train").glob("*.png"))[:3] + sorted((scene / "test").glob("*.png"))[:1]
    for p in paths:
        assert np.array_equal(image_io.read_image(p), _pillow(p)), p


def test_unported_png_and_jpeg_without_pillow_raise(tmp_path, monkeypatch):
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "p.png")
    with pytest.raises(NotImplementedError, match="colour type 3"):
        image_io.read_image(tmp_path / "p.png")
    # 16-bit grey (the depth maps) decodes as Pillow reads it; 16-bit colour
    # does not
    grey16 = (np.arange(16).reshape(4, 4) * 4099).astype(np.uint16)
    Image.fromarray(grey16).save(tmp_path / "i16.png")
    got = image_io.read_image(tmp_path / "i16.png")
    assert got.dtype == np.uint16 and np.array_equal(got[..., 0], np.asarray(Image.open(tmp_path / "i16.png")))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0)
    rgb16 = b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(ihdr)) + b"IHDR" + ihdr + b"\0\0\0\0"
    with pytest.raises(NotImplementedError, match="bit depth 16, colour type 2"):
        image_io.decode_png(rgb16)
    img = _image(np.random.default_rng(3), 16, 16, 3)
    Image.fromarray(img).save(tmp_path / "a.jpg")
    assert np.array_equal(image_io.read_image(tmp_path / "a.jpg"), _pillow(tmp_path / "a.jpg"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        image_io.read_image(tmp_path / "a.jpg")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    return {"ns": make_nerfstudio_fixture(root / "ns", n=5, hw=20),
            "blender": make_blender_fixture(root / "blender", n_train=3, n_val=1, hw=20)}


@pytest.mark.parametrize("alpha_color", ["white", "black", None])
def test_blender_rgba_images_blend_as_jax(captures, alpha_color):
    """The RGBA fixture over white, black and (None) premultiplied: float
    images and the uint8 stack equal to JAX's dataset's."""
    kw = dict(data=captures["blender"], alpha_color=alpha_color)
    j = JInputDataset(JBlender(**kw).setup().get_dataparser_outputs("train"))
    t = InputDataset(BlenderDataParserConfig(**kw).setup().get_dataparser_outputs("train"))
    assert len(t) == len(j) == 3
    for i in range(len(t)):
        np.testing.assert_array_equal(t.get_image_float32(i), np.asarray(j.get_image_float32(i)))
    np.testing.assert_array_equal(t.load_all()["images"], j.load_all()["images"])


def test_nerfstudio_rgb_images_as_jax(captures):
    kw = dict(data=captures["ns"], eval_mode="all")
    j = JInputDataset(JNerfstudio(**kw).setup().get_dataparser_outputs("train"))
    t = InputDataset(NerfstudioDataParserConfig(**kw).setup().get_dataparser_outputs("train"))
    stack = t.load_all()["images"]
    assert stack.shape == (5, 20, 20, 3) and stack.dtype == np.uint8
    np.testing.assert_array_equal(stack, j.load_all()["images"])
    np.testing.assert_array_equal(t.get_image_float32(2), np.asarray(j[2]["image"]))
