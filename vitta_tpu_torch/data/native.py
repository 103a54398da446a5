"""ctypes bindings for the port's native host preprocessing library
(vitta_tpu_torch/csrc/host/vitta_host.cpp, the port's own copy of
csrc/vitta_host.cpp): PIL-exact bilinear resize with antialias, cv2-exact
without, a resize that computes only a crop window of its output, crop,
and the fused uint8 -> float32 normalize.

The library is built with ``g++`` at its first call into
``build/vitta_tpu_torch/libvitta_host_<hash>.so`` at the root of the
checkout; the hash covers the source, the flags and the CPU that
``-march=native`` resolves to, so an edited source or another host
rebuilds it.  It never reuses ``build/libvitta_host.so``, vitta_tpu's
library, which a process may load beside it.  The calls go through
``ctypes.CDLL``, which releases the GIL while the C code runs, so the
``Prefetcher``'s worker threads resample in parallel.

Where the library cannot be built every entry point raises, naming what
is missing: there is no fallback to PIL or numpy.  ``crop_reference`` and
``normalize_reference`` are numpy versions, kept as test oracles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
HOST_SRC_DIR = PACKAGE_DIR / "csrc" / "host"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vitta_tpu_torch"

HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the port's host libraries "
                           "(vitta_tpu_torch/csrc/host/*.cpp) cannot be built")
    return found


def _native_arch(gxx: str) -> str:
    """What ``-march=native`` means on this host, as g++ resolves it."""
    proc = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return proc.stdout


def build_library(name: str, flags: Tuple[str, ...] = HOST_FLAGS,
                  libs: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/host/<name>.cpp`` with ``g++`` unless a library of the
    same source, flags and host CPU exists; return the library's path.
    Raises, with the compiler's message, if the build fails."""
    src = HOST_SRC_DIR / f"{name}.cpp"
    gxx = _gxx()
    key = " ".join((*flags, *libs, _native_arch(gxx))).encode()
    digest = hashlib.sha256(key + src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *flags, str(src), "-o", str(tmp), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"csrc/host/{name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def load_library(name: str, flags: Tuple[str, ...] = HOST_FLAGS,
                 libs: Tuple[str, ...] = (), bind=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/host/<name>.cpp``, built if needed and
    bound by ``bind(lib)`` once; one build and load for all threads."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name, flags, libs)))
            if bind is not None:
                bind(lib)
            _LOADED[name] = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i = ctypes.c_int
    lib.resize_bilinear_u8_batch.argtypes = [u8p, i, i, i, i, u8p, i, i, i]
    lib.resize_bilinear_u8_batch.restype = None
    lib.crop_u8.argtypes = [u8p] + [i] * 8 + [u8p]
    lib.crop_u8.restype = None
    lib.resize_bilinear_u8_window.argtypes = [u8p, i, i, i, i, u8p, i, i, i,
                                              i, i, i, i]
    lib.resize_bilinear_u8_window.restype = None
    lib.normalize_f32.argtypes = [u8p, f32p, ctypes.c_int64, i, f32p, f32p,
                                  i]
    lib.normalize_f32.restype = None


def get_lib() -> ctypes.CDLL:
    """The host library, built with g++ at the first call; raises where it
    cannot be built."""
    return load_library("vitta_host", bind=_bind)


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _frames_u8(frames: np.ndarray) -> Tuple[np.ndarray, bool]:
    """(N, H, W, C) contiguous uint8 from (N, H, W, C) or (H, W, C)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        raise TypeError(f"the host library takes uint8 frames, got "
                        f"{frames.dtype}")
    single = frames.ndim == 3
    if single:
        frames = frames[None]
    if frames.ndim != 4:
        raise ValueError(f"frames must be (N, H, W, C) or (H, W, C), got "
                         f"shape {frames.shape}")
    return np.ascontiguousarray(frames), single


def _check_window(what, h, w, y0, x0, ch, cw):
    if not (0 <= y0 and 0 <= x0 and ch >= 0 and cw >= 0
            and y0 + ch <= h and x0 + cw <= w):
        raise ValueError(f"{what}: window ({y0}, {x0}, {ch}, {cw}) outside "
                         f"{h} x {w}")


def resize_bilinear(frames: np.ndarray, out_h: int, out_w: int,
                    antialias: bool = True) -> np.ndarray:
    """(N, H, W, C) or (H, W, C) uint8 -> resized uint8.

    antialias=True matches PIL BILINEAR (TANet/PIL pipeline);
    antialias=False is classic 2-tap bilinear (cv2/mmcv INTER_LINEAR,
    Swin/mmaction pipeline)."""
    lib = get_lib()
    frames, single = _frames_u8(frames)
    n, h, w, c = frames.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    lib.resize_bilinear_u8_batch(_u8ptr(frames), n, h, w, c, _u8ptr(out),
                                 out_h, out_w, 1 if antialias else 0)
    return out[0] if single else out


def resize_bilinear_window(frames: np.ndarray, out_h: int, out_w: int,
                           y0: int, x0: int, wh: int, ww: int,
                           antialias: bool = True) -> np.ndarray:
    """resize (N,H,W,C) -> (out_h, out_w) then crop (y0, x0, wh, ww) —
    fused: only the surviving output window is computed (bit-identical
    to resize-then-crop; csrc resize_bilinear_u8_window)."""
    lib = get_lib()
    frames, single = _frames_u8(frames)
    n, h, w, c = frames.shape
    _check_window("resize_bilinear_window", out_h, out_w, y0, x0, wh, ww)
    out = np.empty((n, wh, ww, c), np.uint8)
    lib.resize_bilinear_u8_window(_u8ptr(frames), n, h, w, c, _u8ptr(out),
                                  out_h, out_w, 1 if antialias else 0,
                                  y0, x0, wh, ww)
    return out[0] if single else out


def crop(frames: np.ndarray, y0: int, x0: int, ch: int, cw: int) -> np.ndarray:
    """(N, H, W, C) or (H, W, C) uint8 -> its (ch, cw) window at (y0, x0)."""
    lib = get_lib()
    frames, single = _frames_u8(frames)
    n, h, w, c = frames.shape
    _check_window("crop", h, w, y0, x0, ch, cw)
    out = np.empty((n, ch, cw, c), np.uint8)
    lib.crop_u8(_u8ptr(frames), n, h, w, c, y0, x0, ch, cw, _u8ptr(out))
    return out[0] if single else out


def normalize(frames: np.ndarray, mean: Sequence[float], std: Sequence[float],
              div255: bool = True) -> np.ndarray:
    """uint8 (..., C) -> float32 ``(x[/255] - mean) / std`` per channel."""
    lib = get_lib()
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        raise TypeError(f"normalize takes uint8 frames, got {frames.dtype}")
    frames = np.ascontiguousarray(frames)
    c = frames.shape[-1]
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    if not (1 <= c <= 8 and m.shape == s.shape == (c,)):
        raise ValueError(f"normalize: {c} channels (at most 8), mean "
                         f"{m.shape}, std {s.shape}")
    out = np.empty(frames.shape, np.float32)
    lib.normalize_f32(_u8ptr(frames), _f32ptr(out), frames.size // c, c,
                      _f32ptr(m), _f32ptr(s), 1 if div255 else 0)
    return out


def crop_reference(frames: np.ndarray, y0: int, x0: int, ch: int,
                   cw: int) -> np.ndarray:
    """numpy ``crop``, the tests' oracle."""
    return np.ascontiguousarray(frames[:, y0:y0 + ch, x0:x0 + cw])


def normalize_reference(frames: np.ndarray, mean: Sequence[float],
                        std: Sequence[float], div255: bool = True) -> np.ndarray:
    """numpy ``normalize``, the tests' oracle (the library multiplies by
    1 / std where this divides, so the two agree to float32 rounding)."""
    x = frames.astype(np.float32)
    if div255:
        x /= 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
