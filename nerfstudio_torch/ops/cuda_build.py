"""Build and load the port's hand-written CUDA kernels and host routines.

Each ``csrc/*.cu`` source exposes a plain C interface. It is compiled with
``nvcc`` into a shared library at first CUDA use and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). A ``csrc/*.cpp`` source is
host code, compiled the same way with the host's C++ compiler (``$CXX``,
else ``c++``; nvcc needs one too). Libraries land in
``build/nerfstudio_torch/`` beside the package, named by a hash of the
source and the flags, so an unchanged source is never rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerfstudio_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # the stochastic rounding hashes float bits, and the splatting kernels
    # round as their twins: no FMA contraction anywhere
    "-fmad=false",
    "-Xptxas", "-v",
)

HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _compile_command(src: Path) -> list:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS]
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler to build {src}: set CXX or put c++ on the PATH")
    return [cxx, *HOST_FLAGS]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.insert(0, os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit with sm_90a support")


def build(name: str) -> Tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` (or ``<name>.cpp``) unless an up-to-date
    library exists.

    Returns the library path and the seconds spent compiling (0 when cached).
    The compiler's report (for a kernel, ptxas's registers and spills) is
    kept beside the library as ``<lib>.log``."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        src = src.with_suffix(".cpp")
    flags = NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [*_compile_command(src), "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


def build_all(names) -> Dict[str, Tuple[Path, float]]:
    """``build`` every source at once (one nvcc process each, started
    together): {name: (library path, seconds compiling)}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu`` (or ``.cpp``), building it if
    needed."""
    return ctypes.CDLL(str(build(name)[0]))
