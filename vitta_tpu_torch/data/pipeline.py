"""Host -> device feeding with background prefetch.

The port's counterpart of vitta_tpu/data/pipeline.py.  The reference
overlaps decode with GPU compute via DataLoader worker processes
(num_workers=8, corpus/basics.py:432-453, utils/opts.py:63).  Here a
thread pool prepares items ahead of the consumer: decode and the host
library's resampling release the GIL (``ctypes.CDLL``), so threads
overlap on a multi-core host.

On a CUDA device each worker stages its item's arrays in pinned host
memory and copies them to the card with ``non_blocking=True`` on a
``torch.cuda.Stream`` of its own, then records an event.  The consumer's
stream waits on that event before the item is yielded, and every device
tensor is marked as used on the consumer's stream (``record_stream``), so
the caching allocator does not hand its memory to the worker's stream
while the step still reads it.  A pinned buffer is kept until its event
has completed.  A copy from pageable memory (what ``VittaEngine`` does
with a numpy array) cannot overlap the step; one from pinned memory on
another stream can.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def _map_leaves(item, kind, fn):
    """``item`` with ``fn`` applied to every leaf of type ``kind`` in it,
    through the forms the datasets hand out: tuples (``PairedTTADataset``'s
    (views, clip, label)) and dataclasses (a dataset's ``Sample``); other
    leaves (an int label, an index) stay as they are."""
    if isinstance(item, kind):
        return fn(item)
    if isinstance(item, tuple):
        return tuple(_map_leaves(v, kind, fn) for v in item)
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return dataclasses.replace(item, **{
            f.name: _map_leaves(getattr(item, f.name), kind, fn)
            for f in dataclasses.fields(item)})
    return item


class Prefetcher:
    """Ordered multi-worker prefetch of an indexable dataset.

    ``n_workers`` threads call ``dataset[i]`` concurrently; results are
    yielded strictly in index order, from ``start`` (a mid-stream resume),
    with at most ``max(prefetch, n_workers)`` items in flight.  With
    ``device_put`` every numpy array of an item becomes a tensor on
    ``device`` (the card by default; ``"cpu"`` shares the array's memory);
    without it items stay as the dataset made them.
    """

    def __init__(self, dataset, prefetch: int = 2, device_put: bool = True,
                 device="cuda", n_workers: int = 1, start: int = 0):
        self.dataset = dataset
        self.prefetch = max(1, prefetch)
        self.device_put = device_put
        self.device = torch.device(device)
        if (device_put and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"device {str(self.device)!r} was asked for and no CUDA "
                "device is available; pass device=\"cpu\" to stay on the CPU")
        self.n_workers = max(1, n_workers)
        self.start = start

    def _fetch(self, i: int, local: threading.local):
        """Item ``i`` and, on a CUDA device, the event its copies end with
        and the pinned buffers they read."""
        item = self.dataset[i]
        if not self.device_put:
            return item, None, ()
        if self.device.type != "cuda":
            return _map_leaves(item, np.ndarray, torch.from_numpy), None, ()
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(self.device)
        pinned = []

        def to_device(a: np.ndarray) -> torch.Tensor:
            src = torch.from_numpy(np.ascontiguousarray(a))
            host = torch.empty_like(src, pin_memory=True).copy_(src)
            pinned.append(host)
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(stream):
            item = _map_leaves(item, np.ndarray, to_device)
            done = torch.cuda.Event()
            done.record(stream)
        return item, done, pinned

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        window = max(self.prefetch, self.n_workers)
        local = threading.local()       # one copy stream a worker thread
        in_use = collections.deque()    # (event, pinned buffers)
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            pending = collections.deque(
                pool.submit(self._fetch, i, local)
                for i in range(self.start, min(self.start + window, n)))
            nxt = self.start + len(pending)
            try:
                while pending:
                    item, done, pinned = pending.popleft().result()
                    if nxt < n:
                        pending.append(pool.submit(self._fetch, nxt, local))
                        nxt += 1
                    if done is not None:
                        consumer = torch.cuda.current_stream(self.device)
                        consumer.wait_event(done)
                        _map_leaves(item, torch.Tensor,
                                    lambda t: t.record_stream(consumer))
                        in_use.append((done, pinned))
                        while in_use and in_use[0][0].query():
                            in_use.popleft()
                    yield item
            finally:
                for f in pending:
                    f.cancel()
                for done, _pinned in in_use:
                    done.synchronize()

    def __len__(self):
        return len(self.dataset) - self.start
