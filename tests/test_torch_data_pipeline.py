"""The port's ``Prefetcher`` on the CPU (``device="cpu"``): strict index
order with 1, 2 and 4 workers and from ``start`` > 0, at most
``max(prefetch, n_workers)`` items in flight, items as tensors that share
the dataset's arrays (tuples, ``Sample``s), numpy items without
``device_put``, a worker's exception raised to the consumer, the card
asked for where there is none; and one stress run of more workers than
cores over the synthetic source, whose frame cache all workers share
under its lock, against the same items made in order.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vitta_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.data.dataset import PairedTTADataset, TANetVideoDataset
from vitta_tpu_torch.data.pipeline import Prefetcher
from vitta_tpu_torch.data.records import VideoRecord
from vitta_tpu_torch.data.video_reader import SyntheticVideoSource


def _cfg(t):
    cfg = tanet_ucf101_preset()
    return cfg.replace(data=dataclasses.replace(
        cfg.data, clip_length=t, input_size=16, scale_size=20))


class Counting:
    """A dataset of ``n`` items (views, clip, label) that records how far
    ahead of the consumer each fetch ran and how many ran at once."""

    def __init__(self, n, delay=0.0):
        self.n, self.delay = n, delay
        self.lock = threading.Lock()
        self.fetched, self.running, self.most_running = [], 0, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.fetched.append(i)
            self.running += 1
            self.most_running = max(self.most_running, self.running)
        # later items finish first, to shuffle completion order
        time.sleep(self.delay * ((self.n - i) % 3))
        with self.lock:
            self.running -= 1
        return (np.full((2, 3), i, np.uint8), np.arange(4, dtype=np.float32)
                + i, np.asarray([i], np.int32))


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_order_and_window(n_workers, start):
    data = Counting(12, delay=0.002)
    pf = Prefetcher(data, prefetch=2, device="cpu", n_workers=n_workers,
                    start=start)
    assert len(pf) == 12 - start
    window = max(2, n_workers)
    seen = []
    for views, clip, label in pf:
        i = int(label[0])
        seen.append(i)
        assert isinstance(views, torch.Tensor) and views.dtype == torch.uint8
        assert clip.dtype == torch.float32 and label.dtype == torch.int32
        assert views.device.type == "cpu" and int(views[0, 0]) == i
        # nothing past the window was asked for before this item came out
        with data.lock:
            assert max(data.fetched) < i + window + 1
    assert seen == list(range(start, 12))
    assert sorted(data.fetched) == list(range(start, 12))
    assert data.most_running <= n_workers
    # the same order as vitta_tpu's Prefetcher
    jseen = [int(lb[0]) for _v, _c, lb in JaxPrefetcher(
        Counting(12), device_put=False, n_workers=n_workers, start=start)]
    assert jseen == seen


def test_numpy_items_without_device_put_and_samples_as_tensors():
    recs = [VideoRecord(f"v{i}", 30 + i, i) for i in range(3)]
    ds = TANetVideoDataset(_cfg(2), SyntheticVideoSource(24, 32), recs,
                           emit_uint8=True)
    raw = list(Prefetcher(ds, device_put=False, device="cpu", n_workers=2))
    assert all(isinstance(s.frames, np.ndarray) for s in raw)
    put = list(Prefetcher(ds, device="cpu", n_workers=2))
    for i, (a, b) in enumerate(zip(raw, put)):
        assert type(b).__name__ == "Sample" and b.index == a.index == i
        assert isinstance(b.frames, torch.Tensor) and b.label == a.label
        np.testing.assert_array_equal(b.frames.numpy(), a.frames)


def test_worker_exception_reaches_the_consumer():
    class Broken(Counting):
        def __getitem__(self, i):
            if i == 2:
                raise KeyError("item 2")
            return super().__getitem__(i)

    got = []
    with pytest.raises(KeyError, match="item 2"):
        for item in Prefetcher(Broken(6), device="cpu", n_workers=2):
            got.append(int(item[2][0]))
    assert got == [0, 1]


def test_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(Counting(2))
    assert Prefetcher(Counting(2), device_put=False).device.type == "cuda"


def test_stress_shared_source_cache():
    """16 workers (more than the cores), a short switch interval, a cache
    smaller than the stream's frames: every item equals the one made in
    order from a fresh source."""
    cfg = _cfg(4)
    recs = [VideoRecord(f"s{i}", 40, i) for i in range(24)]
    want = PairedTTADataset(cfg, SyntheticVideoSource(24, 32), recs,
                            emit_uint8=True)
    src = SyntheticVideoSource(24, 32)
    src._CACHE_CAP = 64
    paired = PairedTTADataset(cfg, src, recs, emit_uint8=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.perf_counter()
    try:
        got = list(Prefetcher(paired, prefetch=16, device="cpu",
                              n_workers=16))
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 120
    assert len(got) == len(recs)
    for i, (views, clip, label) in enumerate(got):
        wv, wc, wl = want[i]
        np.testing.assert_array_equal(views.numpy(), wv)
        np.testing.assert_array_equal(clip.numpy(), wc)
        assert int(label[0]) == int(wl[0]) == i
    assert len(src._cache) <= 64
