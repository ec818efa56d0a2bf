"""PLY reader and writer (counterpart of ``nerfstudio_tpu/exporter/ply_io.py``):
host-side numpy. ``read_ply`` reads the dataparsers' seed points;
``write_ply`` writes the exporter's point clouds, meshes' vertices and 3DGS
splats as binary little-endian PLYs, byte for byte as the reference writes
them."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PLY_TO_NP = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "int": np.int32,
    "uint": np.uint32,
    "short": np.int16,
    "ushort": np.uint16,
    "char": np.int8,
}


def read_ply(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """xyz (N, 3) float32 and rgb (N, 3) uint8 (None without colour) from an
    ascii or binary little-endian PLY."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_verts = 0
        props = []
        in_vertex = False
        for line in header:
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, _PLY_TO_NP[typ]))

        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_verts)]
            data = np.array(rows, dtype=np.float64)
            cols = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            dtype = np.dtype([(name, np.dtype(t).newbyteorder("<")) for name, t in props])
            raw = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype)
            cols = {name: raw[name].astype(np.float64) for name, _ in props}

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    rgb = None
    if "red" in cols:
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1).astype(np.uint8)
    return xyz, rgb


def write_ply(path: Path, count: int, fields: Dict[str, np.ndarray]) -> None:
    """A binary little-endian PLY of ``count`` vertices with one float32 or
    uint8 property per field, in the order given (reference :68-94)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    for name, arr in fields.items():
        if arr.shape != (count,):
            raise ValueError(f"field {name} has shape {arr.shape}, expected ({count},)")
        if arr.dtype not in (np.float32, np.uint8):
            raise ValueError(f"field {name} dtype {arr.dtype} must be float32 or uint8")
    stacked = np.empty(count, dtype=np.dtype([(n, a.dtype) for n, a in fields.items()]))
    for name, arr in fields.items():
        stacked[name] = arr
    header = ["ply", "format binary_little_endian 1.0", "comment Generated by nerfstudio_tpu",
              f"element vertex {count}"]
    header += [f"property {'float' if a.dtype == np.float32 else 'uchar'} {n}" for n, a in fields.items()]
    with open(path, "wb") as f:
        f.write(("\n".join(header + ["end_header"]) + "\n").encode())
        f.write(stacked.tobytes())
