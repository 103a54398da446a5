"""Tracing, profiling and metrics.

The PyTorch counterpart of vitta_tpu/utils/observability.py.  The
reference's observability is wall-clock meters and a TensorBoard writer
(utils_.py:92-110, corpus/main_eval.py:85).  Here:

* :class:`MetricsWriter` — a JSONL scalar stream (one line per value:
  ``{"step": n, "tag": ..., "value": ..., "ts": ...}``), mirrored to
  tensorboardX where that package is installed;
* :func:`profile` — a context manager around ``torch.profiler`` that writes
  a Chrome trace (open it in Perfetto or chrome://tracing);
* :class:`StepTimer` — wall-clock step timing that waits for the card's
  queued work before it reads the clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class MetricsWriter:
    def __init__(self, result_dir: str, name: str = "metrics"):
        os.makedirs(result_dir, exist_ok=True)
        self.path = os.path.join(result_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # optional
            self._tb = SummaryWriter(os.path.join(result_dir, "tb"))
        except Exception:
            pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps(
            {"step": int(step), "tag": tag, "value": float(value),
             "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile(profile_dir: str, enabled: bool = True):
    """``with profile("traces"):`` records the host and, where there is a
    card, its kernels with ``torch.profiler`` and writes
    ``<profile_dir>/trace.json`` when the block ends."""
    if not enabled or not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class StepTimer:
    """Wall-clock timing; ``elapsed_ms(sync_on=...)`` first waits for the
    queued work of ``sync_on``'s device (a tensor or a device) to finish,
    as ``jax.block_until_ready`` does in vitta_tpu."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed_ms(self, sync_on=None) -> float:
        if sync_on is not None:
            device = (sync_on.device if isinstance(sync_on, torch.Tensor)
                      else torch.device(sync_on))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return (time.perf_counter() - self._t0) * 1000.0
