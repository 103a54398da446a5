"""Video frame sources.

The port's copy of vitta_tpu/data/video_reader.py.  PIL and decord are
imported only inside the sources that need them (the frame-folder source
and ``DecordVideoSource``): importing this module loads neither.

The reference decodes videos with decord (C++/FFmpeg random-access
decode, models/tanet_models/video_dataset.py:320-341).  Here decode is
an interface with several backends:

* :class:`FFmpegVideoSource` — the first-party native decoder
  (vitta_tpu_torch/csrc/host/vitta_decode.cpp, libav-backed; preferred
  for kind='video');
* :class:`DecordVideoSource` — when decord is installed;
* :class:`NpyVideoSource` — videos stored as ``(N, H, W, 3)`` uint8
  ``.npy`` files (the fixture format, also a fast ingest format for
  benchmark runs: decode once, mmap thereafter);
* :class:`SyntheticVideoSource` — deterministic procedural videos for
  CI and benchmarking without data (replaces decord in tests,
  SURVEY.md §4);
* a native C++ decoder can slot in behind the same two methods.

All sources return uint8 (T, H, W, 3) for a list of frame indices that
are already clamped by the samplers.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading

import numpy as np


class VideoSource:
    def num_frames(self, path: str) -> int:
        raise NotImplementedError

    def get_batch(self, path: str, indices: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:  # default: nothing to release
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _CachedReaderSource(VideoSource):
    """Shared machinery for sources that hold an open decoder per video.

    The default pipeline drives ``num_frames``/``get_batch`` from a
    thread pool (``Prefetcher``, data/pipeline.py), so the one-reader cache
    is **per thread**: each worker holds its own open container and is
    the only thread that ever closes it (when its own cursor moves to
    another video).  A shared single-reader cache would let one thread
    close a native decoder while another is mid-decode on the same
    handle (use-after-free), and would share one decode cursor between
    threads (corrupt frames).

    ``close()`` releases every reader the source has opened; it must
    only be called once worker threads are done with the source (the
    context-manager form expresses that scoping).  A generation counter
    makes any thread-local reader that survived a ``close()`` invalid,
    so a reused source reopens instead of touching a closed handle.
    """

    def __init__(self, data_dir: str, vid_format: str = ""):
        self.data_dir = data_dir
        self.vid_format = vid_format
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._open_readers: list = []
        self._generation = 0

    # -- subclass hooks ---------------------------------------------------
    def _open(self, full_path: str):
        raise NotImplementedError

    @staticmethod
    def _close_reader(reader) -> None:
        close = getattr(reader, "close", None)
        if close is not None:
            close()

    # -- shared cache -----------------------------------------------------
    def _reader(self, path: str):
        full = os.path.join(self.data_dir, f"{path}{self.vid_format}")
        tls = self._tls
        with self._lock:
            generation = self._generation
        if (getattr(tls, "path", None) != full
                or getattr(tls, "generation", -1) != generation):
            old = getattr(tls, "reader", None)
            if old is not None:
                tls.reader = tls.path = None
                with self._lock:
                    if old in self._open_readers:
                        self._open_readers.remove(old)
                        # safe: only this thread ever used `old`
                        self._close_reader(old)
            reader = self._open(full)
            with self._lock:
                self._open_readers.append(reader)
            tls.reader = reader
            tls.path = full
            tls.generation = generation
        return tls.reader

    def close(self) -> None:
        with self._lock:
            readers, self._open_readers = self._open_readers, []
            self._generation += 1
        for r in readers:
            self._close_reader(r)


class DecordVideoSource(_CachedReaderSource):
    def __init__(self, data_dir: str, vid_format: str = ""):
        import decord  # noqa: F401
        super().__init__(data_dir, vid_format)
        self._decord = decord

    def _open(self, full_path: str):
        return self._decord.VideoReader(full_path)

    def num_frames(self, path: str) -> int:
        return len(self._reader(path))

    def get_batch(self, path: str, indices: np.ndarray) -> np.ndarray:
        vr = self._reader(path)
        idx = np.minimum(indices, len(vr) - 1)
        return vr.get_batch(idx).asnumpy()


class FFmpegVideoSource(_CachedReaderSource):
    """First-party native decode (csrc/host/vitta_decode.cpp via libav) —
    same contract as decord's VideoReader/get_batch
    (models/tanet_models/video_dataset.py:320-341), no third-party
    decoder dependency.  Keeps one open container cached per worker
    thread, matching the sequential per-video access pattern of the
    stream loops."""

    def __init__(self, data_dir: str, vid_format: str = ""):
        from vitta_tpu_torch.data import native_decode
        native_decode.get_lib()   # raises, naming what is missing
        super().__init__(data_dir, vid_format)
        self._nd = native_decode

    def _open(self, full_path: str):
        return self._nd.NativeVideoReader(full_path)

    def num_frames(self, path: str) -> int:
        return len(self._reader(path))

    def get_batch(self, path: str, indices: np.ndarray) -> np.ndarray:
        vr = self._reader(path)
        # index clamp as decord path does (video_dataset.py:328)
        idx = np.minimum(np.asarray(indices), len(vr) - 1)
        return vr.get_batch(idx)


class NpyVideoSource(VideoSource):
    """Each video is ``<data_dir>/<path>.npy``: (N, H, W, 3) uint8."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir

    def _load(self, path: str) -> np.ndarray:
        return np.load(os.path.join(self.data_dir, f"{path}.npy"), mmap_mode="r")

    def num_frames(self, path: str) -> int:
        return self._load(path).shape[0]

    def get_batch(self, path: str, indices: np.ndarray) -> np.ndarray:
        arr = self._load(path)
        idx = np.minimum(indices, arr.shape[0] - 1)
        return np.ascontiguousarray(arr[idx])


class SyntheticVideoSource(VideoSource):
    """Deterministic procedural videos: per-frame patterns keyed by
    (video path, frame index) so any sampler sees consistent content.
    A class-dependent spatial pattern makes tiny end-to-end accuracy
    sanity checks possible."""

    # rendered frames are deterministic in (path, t, h, w) — cache them
    # across get_batch calls so repeated sampling of the same video
    # (TTA views + eval clip, bench loops) pays the render once.  ~256 KB
    # per 256x340 frame; the cap bounds the cache at ~1 GB.
    _CACHE_CAP = 4096

    def __init__(self, height: int = 240, width: int = 320,
                 frames_per_video: int = 120):
        self.height = height
        self.width = width
        self.frames_per_video = frames_per_video
        self._cache: "collections.OrderedDict[tuple, np.ndarray]" = \
            collections.OrderedDict()
        self._cache_lock = threading.Lock()  # Prefetcher shares one source

    def _seed(self, path: str) -> int:
        return int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")

    def num_frames(self, path: str) -> int:
        # vary length deterministically in [0.5x, 1.5x)
        s = self._seed(path)
        return self.frames_per_video // 2 + s % self.frames_per_video

    def get_batch(self, path: str, indices: np.ndarray) -> np.ndarray:
        # The pattern is separable (base = cos(y') + sin(x'), and a roll
        # of the 2D base equals a roll of the corresponding 1D vector),
        # so each channel is an outer sum of two 1-D vectors: per-frame
        # cost drops to a few cache-resident (H, W) passes.  Values are
        # bit-identical to the original per-pixel formulation.  Synthetic
        # "decode" must stay far cheaper than the real preprocessing it
        # feeds, or host-pipeline benchmarks measure the fixture
        # (round-2 PERF.md's 74-89 ms/video was ~70% this loop).
        s = self._seed(path)
        n = self.num_frames(path)
        idx = np.minimum(np.asarray(indices), n - 1)
        h, w = self.height, self.width
        xs = np.arange(w, dtype=np.float32) / (8 + s % 13)
        ys = np.arange(h, dtype=np.float32) / (11 + s % 7)
        out = np.empty((len(idx), h, w, 3), np.uint8)
        scratch = np.empty((h, w), np.float32)
        for i, t in enumerate(idx):
            key = (path, int(t), h, w)
            with self._cache_lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
            if hit is not None:
                out[i] = hit
                continue
            phase = 2 * np.pi * (float(t) / max(n, 1))
            sx = np.sin(xs + phase)
            cy = np.cos(ys - phase)
            cy_r = np.roll(cy, s % 16)
            sx_r = np.roll(sx, s % 9)
            for ch, (a, b) in enumerate(((cy, sx), (cy_r, sx), (cy, sx_r))):
                f = np.add(a[:, None], b[None, :], out=scratch)
                f *= 60.0
                f += 127.0
                np.clip(f, 0, 255, out=f)
                out[i, :, :, ch] = f
            with self._cache_lock:
                self._cache[key] = out[i].copy()
                if len(self._cache) > self._CACHE_CAP:
                    self._cache.popitem(last=False)
        return out


class FrameDirVideoSource(VideoSource):
    """Frame-folder (JPEG) videos: ``<data_dir>/<path>/<tmpl % (i+1)>``
    — the reference's 'frame' datatype (opts.py:23; deprecated loaders
    MyTSNDataset/MyDataset, datasets_/dataset_deprecated.py:28-396)."""

    def __init__(self, data_dir: str, image_tmpl: str = "img_{:05d}.jpg"):
        self.data_dir = data_dir
        self.image_tmpl = image_tmpl

    def _dir(self, path: str) -> str:
        return os.path.join(self.data_dir, path)

    def num_frames(self, path: str) -> int:
        import glob
        pattern = self.image_tmpl.replace("{:05d}", "*").replace("{:06d}", "*")
        return len(glob.glob(os.path.join(self._dir(path), pattern)))

    def get_batch(self, path: str, indices: np.ndarray) -> np.ndarray:
        from PIL import Image
        frames = []
        for i in np.asarray(indices):
            # frame files are 1-based (dataset_deprecated.py image_tmpl use)
            fp = os.path.join(self._dir(path), self.image_tmpl.format(int(i) + 1))
            frames.append(np.asarray(Image.open(fp).convert("RGB")))
        return np.stack(frames)


def make_video_source(kind: str, data_dir: str = "", vid_format: str = "",
                      **kw) -> VideoSource:
    if kind == "video":
        # the reference's 'video' datatype (opts.py:23): container files
        # decoded on demand — prefer the first-party native decoder,
        # take decord when only that is installed
        from vitta_tpu_torch.data import native_decode
        if native_decode.available():
            return FFmpegVideoSource(data_dir, vid_format)
        try:
            return DecordVideoSource(data_dir, vid_format)
        except ImportError as e:
            raise RuntimeError(
                "no video decoder: the native decoder needs libav's headers "
                "and libraries and g++ (vitta_tpu_torch/csrc/host/"
                "vitta_decode.cpp), and decord is not installed") from e
    if kind == "ffmpeg":
        return FFmpegVideoSource(data_dir, vid_format)
    if kind == "decord":
        return DecordVideoSource(data_dir, vid_format)
    if kind == "npy":
        return NpyVideoSource(data_dir)
    if kind == "frames":
        return FrameDirVideoSource(data_dir, **kw)
    if kind == "synthetic":
        return SyntheticVideoSource(**kw)
    raise ValueError(f"unknown video source kind={kind}")
