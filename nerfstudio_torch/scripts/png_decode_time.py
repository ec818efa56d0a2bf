"""Host time of the datasets' PNG decoder (``data/image_io.read_image``):

    python -m nerfstudio_torch.scripts.png_decode_time DIR [--write N HxW]

``--write`` first writes N RGB stand-ins for photographs of H x W into
DIR with Pillow (a smooth gradient and soft discs, saved with Pillow's
default adaptive row filters): the even frames noise-free, which Pillow
writes with Paeth rows, the odd ones with sensor noise, which it writes
with Sub and Up rows. Then every PNG in DIR is decoded
and its time printed with its size and row filters, as one JSON line each
and a summary."""

from __future__ import annotations

import json
import sys
import time
import zlib
from pathlib import Path

import numpy as np

from nerfstudio_torch.data import image_io


def write_images(out: Path, n: int, h: int, w: int) -> None:
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    for i in range(n):
        img = np.stack([0.5 + 0.4 * np.sin(6 * x + i), 0.5 + 0.4 * np.cos(5 * y - i), 0.5 + 0.3 * x * y], -1)
        for _ in range(12):
            cy, cx, rad = rng.uniform(0, h / max(h, w)), rng.uniform(0, w / max(h, w)), rng.uniform(0.03, 0.2)
            disc = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / rad**2)[..., None]
            img = img * (1 - disc) + rng.uniform(0, 1, 3) * disc
        img = np.clip(img * 255 + rng.normal(0, 3 * (i % 2), img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(out / f"frame_{i:05d}.png")


def row_filters(data: bytes) -> dict:
    """{filter type: rows} of a decodable PNG."""
    w, h, _, ctype, _ = image_io._header(data)
    idat = b"".join(body for tag, body in image_io._chunks(data) if tag == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8).reshape(h, -1)
    kinds, counts = np.unique(raw[:, 0], return_counts=True)
    return {int(k): int(c) for k, c in zip(kinds, counts)}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return {}
    folder = Path(argv[0])
    if "--write" in argv:
        i = argv.index("--write")
        h, w = (int(v) for v in argv[i + 2].split("x"))
        write_images(folder, int(argv[i + 1]), h, w)
    times = []
    for path in sorted(folder.glob("*.png")):
        data = path.read_bytes()
        t0 = time.perf_counter()
        img = image_io.read_image(path)
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        print(json.dumps({"file": path.name, "shape": list(img.shape), "bytes": len(data), "ms": ms,
                          "row_filters": row_filters(data)}), flush=True)
    summary = {"images": len(times), "ms_mean": float(np.mean(times)) if times else None,
               "ms_max": max(times, default=None)}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
