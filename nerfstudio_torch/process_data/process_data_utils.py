"""Shared capture-ingestion helpers (counterpart of
``nerfstudio_tpu/process_data/process_data_utils.py``; reference
nerfstudio/process_data/process_data_utils.py).

Host code only: listing and copying images with their ``images_2/4/8``
pyramids, and extracting video frames with ffmpeg (a subprocess; it raises
without the binary). The pyramids are resized as the reference's Pillow
``Image.resize`` does by default, with Pillow's antialiased bicubic filter
ported here in numpy (``resize_bicubic``) to Pillow's bytes, so PNG
captures need no Pillow; the same engine with Pillow's triangle filter is
its bilinear resize (``resize_bilinear``, the datasets' ``scale_factor``). JPEG, TIFF and BMP files are read and written
through Pillow where it imports and refused where it does not, as
``data/image_io`` rules for JPEG."""

from __future__ import annotations

import math
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

ALLOWED_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp")

# Pillow's resampling keeps 22 fractional bits in its 8-bit passes
# (libImaging/Resample.c PRECISION_BITS = 32 - 8 - 2)
_PRECISION_BITS = 22


def list_images(directory: Path) -> List[Path]:
    return sorted(p for p in Path(directory).iterdir() if p.suffix.lower() in ALLOWED_EXTS)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, support 2 (Pillow's
    ``bicubic_filter``)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    """The triangle kernel, support 1 (Pillow's ``bilinear_filter``)."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# Pillow's filters as (kernel, support)
BICUBIC = (_bicubic, 2.0)
BILINEAR = (_triangle, 1.0)


def _coefficients(in_size: int, out_size: int, filt=BICUBIC) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), fixed-point weights (out, ksize) int64) of
    one axis under ``filt``, as Pillow's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` make them: the filter's support scaled by the
    downscale factor, each output's taps in double precision, normalised to
    sum 1, then rounded half away from zero to 22 fractional bits; taps past
    the input's edge are dropped before the normalisation."""
    kernel, filter_support = filt
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start clamps to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None, :]
    w = kernel((x + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x < xmax[:, None], w, 0.0)
    total = np.zeros((out_size, 1))
    for t in range(ksize):  # in tap order, as Pillow sums them
        total = total + w[:, t : t + 1]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)), np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_axis(image: np.ndarray, out_size: int, axis: int, filt=BICUBIC) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of (H, W, C) uint8,
    as Pillow's ``ImagingResampleHorizontal/Vertical_8bpc``: a sum of
    uint8 x fixed-point products from half a unit, then shifted down and
    clipped to 0..255."""
    in_size = image.shape[axis]
    xmin, k = _coefficients(in_size, out_size, filt)
    src = np.moveaxis(image, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)  # a tap past the edge has weight 0
        acc += src[idx] * k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(image: np.ndarray) -> np.ndarray:
    """RGBA/LA -> Pillow's premultiplied RGBa/La (Convert.c ``rgbA2rgba``:
    c * a / 255 rounded by its MULDIV255)."""
    c, a = image[..., :-1].astype(np.int64), image[..., -1:].astype(np.int64)
    t = c * a + 128
    return np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)


def _unpremultiply(image: np.ndarray) -> np.ndarray:
    """Pillow's RGBa/La -> RGBA/LA (Convert.c ``rgba2rgbA``): 255 c / a,
    floored and clipped, where 0 < a < 255."""
    c, a = image[..., :-1].astype(np.int64), image[..., -1:].astype(np.int64)
    c = np.where((a == 255) | (a == 0), c, np.clip(255 * c // np.maximum(a, 1), 0, 255))
    return np.concatenate([c, a], axis=-1).astype(np.uint8)


def resize_bicubic(image: np.ndarray, width: int, height: int, filt=BICUBIC) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 -> (height, width[, C]) uint8, the bytes of
    Pillow's ``Image.resize((width, height))`` at its default filter
    (antialiased bicubic), or at ``filt`` (``BILINEAR``: ``resize_bilinear``),
    of an "L", "LA", "RGB" or "RGBA" image: the horizontal pass first, then
    the vertical, each skipped where its size does not change; an image
    with alpha resized premultiplied, as Pillow does; the same size is a
    copy."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"the resampler takes uint8 images, got {image.dtype}")
    if (height, width) == image.shape[:2]:
        return image.copy()  # Pillow returns a copy before any conversion
    grey = image.ndim == 2
    out = image[..., None] if grey else image
    alpha = out.shape[-1] in (2, 4)
    if alpha:
        out = _premultiply(out)
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1, filt)
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0, filt)
    if alpha:
        out = _unpremultiply(out)
    return out[..., 0] if grey else out


def resize_bilinear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """The bytes of Pillow's ``Image.resize((width, height),
    Image.BILINEAR)``: ``resize_bicubic`` with the triangle filter."""
    return resize_bicubic(image, width, height, BILINEAR)


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("JPEG, TIFF and BMP images need Pillow, which is not installed: convert the capture "
                          "to PNG, which the port reads and writes itself") from e
    return Image


def read_image(path: Path) -> np.ndarray:
    """An 8-bit image file -> (H, W) or (H, W, C) uint8 as Pillow holds it
    ("L", "LA", "RGB", "RGBA"): PNG through ``data/image_io``, other formats
    through Pillow."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        from nerfstudio_torch.data.image_io import read_image as read_png

        arr = read_png(path)
        if arr.dtype != np.uint8:
            raise ValueError(f"{path}: only 8-bit images are resized")
        return arr[..., 0] if arr.shape[-1] == 1 else arr
    with _pillow().open(path) as im:
        return np.asarray(im)


def write_image(path: Path, image: np.ndarray) -> None:
    """uint8 (H, W) or (H, W, C) -> a file of ``path``'s format: PNG by
    ``data/image_io.write_png``, other formats by Pillow at its defaults."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        from nerfstudio_torch.data.image_io import write_png

        write_png(path, image)
        return
    _pillow().fromarray(image).save(path)


def copy_images(source: Path, dest_dir: Path, num_downscales: int = 3, rename: bool = True) -> List[Path]:
    """Copy the images into ``dest_dir/images``, with ``images_2``,
    ``images_4``, ... pyramids (reference copy_images + downscale). Returns
    the copied full-resolution paths."""
    dest_dir = Path(dest_dir)
    images = list_images(source)
    if not images:
        raise FileNotFoundError(f"no images found in {source}")
    dirs = [dest_dir / "images"] + [dest_dir / f"images_{2**i}" for i in range(1, num_downscales + 1)]
    for d in dirs:
        d.mkdir(parents=True, exist_ok=True)
    out_paths = []
    for i, src in enumerate(images):
        name = f"frame_{i + 1:05d}{src.suffix.lower()}" if rename else src.name
        dst = dest_dir / "images" / name
        shutil.copy2(src, dst)
        out_paths.append(dst)
        img = read_image(dst)
        for level in range(1, num_downscales + 1):
            f = 2**level
            h, w = img.shape[:2]
            write_image(dest_dir / f"images_{f}" / name, resize_bicubic(img, max(1, w // f), max(1, h // f)))
    return out_paths


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def convert_video_to_images(video_path: Path, output_dir: Path, num_frames_target: int = 300) -> List[Path]:
    """Extract evenly spaced frames with ffmpeg (reference
    convert_video_to_images). Needs the ffmpeg binary."""
    if not ffmpeg_available():
        raise RuntimeError("ffmpeg is required for video ingestion but was not found on PATH")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-show_entries", "format=duration",
         "-of", "default=noprint_wrappers=1:nokey=1", str(video_path)],
        capture_output=True, text=True, check=True,
    )
    duration = float(probe.stdout.strip() or 1.0)
    fps = max(num_frames_target / max(duration, 1e-6), 0.1)
    subprocess.run(
        ["ffmpeg", "-y", "-i", str(video_path), "-vf", f"fps={fps:.4f}", str(output_dir / "frame_%05d.png")],
        check=True, capture_output=True,
    )
    return list_images(output_dir)


def downscale_factor_dirs(base: Path, factors=(2, 4, 8)) -> None:
    """``base/images_<f>`` for each factor from ``base/images``."""
    imgs = list_images(base / "images")
    for f in factors:
        d = base / f"images_{f}"
        d.mkdir(exist_ok=True)
        for p in imgs:
            img = read_image(p)
            h, w = img.shape[:2]
            write_image(d / p.name, resize_bicubic(img, max(1, w // f), max(1, h // f)))
