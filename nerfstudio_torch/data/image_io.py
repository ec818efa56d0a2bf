"""Image files to arrays without Pillow or libpng (the datasets'
decoder; the JAX package reads through Pillow and a C++ loader).

PNG is decoded here with the standard library's ``zlib`` and a small host
routine (``csrc/png_unfilter.cpp``) for the row filters: 8-bit samples of
colour types 0 (grey), 2 (RGB), 4 (grey and alpha) and 6 (RGBA) as uint8,
16-bit grey (the depth maps users ship) as uint16, no interlacing, and all
five row filters. JPEG goes through Pillow where it imports; without it a
JPEG raises ``ImportError``. ``write_png`` writes 8-bit grey, RGB or RGBA
PNGs (row filter None, zlib), so captures and fixtures are written without
Pillow too; ``encode_png`` makes the same bytes in memory (the viewer's
frames)."""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos : pos + 8])
        yield tag, data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IEND":
            return


def _header(data: bytes) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of a PNG."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    tag, ihdr = next(_chunks(data))
    if tag != b"IHDR":
        raise ValueError("PNG without IHDR first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    return w, h, depth, ctype, interlace


_LIB = None


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9) in
    ``csrc/png_unfilter.cpp``, built with the host's C++ compiler at first
    use: None, Sub, Up, Average and Paeth, each on bytes mod 256."""
    global _LIB
    if _LIB is None:
        from nerfstudio_torch.ops import cuda_build

        lib = cuda_build.load("png_unfilter")
        lib.nst_png_unfilter.restype = ctypes.c_int64
        lib.nst_png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_void_p] + [ctypes.c_int64] * 3
        _LIB = lib
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), dtype=np.uint8)
    bad = _LIB.nst_png_unfilter(raw, out.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"unknown PNG row filter {raw[(bad - 1) * (stride + 1)]} on row {bad - 1}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) as stored: uint8 with C = 1, 2, 3 or 4, or
    uint16 with C = 1 for 16-bit grey (as Pillow reads it for the reference's
    ``DepthDataset``)."""
    w, h, depth, ctype, interlace = _header(data)
    if ctype not in _CHANNELS or interlace != 0 or (depth, ctype) not in ((8, ctype), (16, 0)):
        raise NotImplementedError(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace {interlace}: only non-interlaced 8-bit "
            "grey, RGB, grey+alpha and RGBA, and 16-bit grey, are decoded")
    idat = b"".join(body for tag, body in _chunks(data) if tag == b"IDAT")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8  # the filters work on bytes, bpp bytes to the left
    rows = _unfilter(zlib.decompress(idat), h, w * bpp, bpp)
    if depth == 16:  # big-endian samples
        return rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    return rows.reshape(h, w, c)


def _is_jpeg(path: Path) -> bool:
    return Path(path).suffix.lower() in (".jpg", ".jpeg")


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading JPEG images needs Pillow, which is not installed: convert the images to PNG, "
                          "which the port decodes itself") from e
    return Image


def read_image(path: Path) -> np.ndarray:
    """An image file -> (H, W, C) as stored: uint8 (C = 1, 2, 3 or 4), or
    uint16 (C = 1) for a 16-bit grey PNG."""
    if _is_jpeg(path):
        with _pillow().open(path) as im:
            arr = np.asarray(im, dtype=np.uint8)
        return arr[..., None] if arr.ndim == 2 else arr
    return decode_png(Path(path).read_bytes())


def image_size(path: Path) -> Tuple[int, int]:
    """(width, height) of an image file from its header."""
    if _is_jpeg(path):
        with _pillow().open(path) as im:
            return im.size
    with open(path, "rb") as f:
        w, h, *_ = _header(f.read(33))
    return w, h


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W, C) or (H, W) uint8, C in 1, 3, 4 -> the bytes of an 8-bit PNG
    (row filter None, zlib at ``level``)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG encoding takes uint8 images, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: Path, image: np.ndarray) -> None:
    """(H, W, C) or (H, W) uint8, C in 1, 3, 4 -> an 8-bit PNG at ``path``."""
    Path(path).write_bytes(encode_png(image))
