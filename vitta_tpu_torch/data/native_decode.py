"""ctypes bindings for the port's native video decoder
(vitta_tpu_torch/csrc/host/vitta_decode.cpp, the port's own copy of
csrc/vitta_decode.cpp).

First-party replacement for decord (the reference's C++/FFmpeg decode
dependency: requirements.txt:12; used at
models/tanet_models/video_dataset.py:320-341).  The library links against
the system libav*/libswscale and is built with ``g++`` at its first call
into ``build/vitta_tpu_torch/`` (``native.build_library``, with the libav
flags of vitta_tpu/data/native_decode.py:26).  ``available`` says whether
it builds and loads; ``make_video_source("video")`` then takes it, else
decord, as vitta_tpu does.  Every other entry point raises where it cannot
be built, naming what is missing.
"""

from __future__ import annotations

import ctypes

import numpy as np

from vitta_tpu_torch.data import native

DECODE_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBAV_FLAGS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_open.restype = ctypes.c_void_p
    for fn in (lib.vd_num_frames, lib.vd_width, lib.vd_height):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vd_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, u8p]
    lib.vd_get_batch.restype = ctypes.c_int
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_close.restype = None
    lib.vd_write_test_video.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.vd_write_test_video.restype = ctypes.c_int


def get_lib() -> ctypes.CDLL:
    """The decoder library, built at the first call; raises, with the
    compiler's or the loader's message, where libav's headers or libraries
    or g++ are missing."""
    try:
        return native.load_library("vitta_decode", DECODE_FLAGS, LIBAV_FLAGS,
                                   bind=_bind)
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the native video decoder cannot be built or "
                           f"loaded (it needs libav's headers and libraries "
                           f"and g++): {e}") from e


def available() -> bool:
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


class NativeVideoReader:
    """decord.VideoReader-shaped wrapper over one open container."""

    def __init__(self, path: str):
        lib = get_lib()
        self._lib = lib
        self._h = lib.vd_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")
        self.num_frames = lib.vd_num_frames(self._h)
        self.height = lib.vd_height(self._h)
        self.width = lib.vd_width(self._h)

    def __len__(self) -> int:
        return self.num_frames

    def get_batch(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        if idx.ndim != 1 or (idx.size and (idx.min() < 0
                                           or idx.max() >= self.num_frames)):
            raise IndexError(f"frame indices outside [0, {self.num_frames})")
        out = np.empty((len(idx), self.height, self.width, 3), np.uint8)
        rc = self._lib.vd_get_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"decode failed (rc={rc})")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_test_video(path: str, frames: np.ndarray, fps: int = 25,
                     gop: int = 12) -> None:
    """Encode (N, H, W, 3) uint8 RGB frames as an mpeg4 AVI (test support)."""
    lib = get_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"write_test_video takes RGB frames, got {c} "
                         "channels")
    rc = lib.vd_write_test_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, fps, gop)
    if rc != 0:
        raise IOError(f"encode failed (rc={rc})")
