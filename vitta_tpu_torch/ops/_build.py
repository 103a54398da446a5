"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``vitta_tpu_torch/csrc/<name>.cu`` exports a plain C interface and is
compiled on first use into ``build/vitta_tpu_torch/lib<name>_<hash>.so``
at the root of the checkout.  The hash covers the source, the shared
headers (``csrc/*.cuh``) and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused.
Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` there.
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
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vitta_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``, as torch.utils.cpp_extension assumes)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; return the library's path.  Raises if nvcc fails."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + headers
                            + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu``, one ``nvcc`` per source and all at once;
    return the seconds each took (near 0 when the library was already
    built).  Raises if any build fails."""
    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    names = [src.stem for src in sorted(CSRC_DIR.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def loaded_libraries():
    """The kernel libraries this process has loaded so far."""
    return list(_LOADED.values())


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
