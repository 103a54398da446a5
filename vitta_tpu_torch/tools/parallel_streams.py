"""TANet streams as processes sharing one card, then each stream alone.

    torchrun --standalone --nproc_per_node 2 \\
        -m vitta_tpu_torch.tools.parallel_streams OUT

Each process of the group adapts one stream: first all of them at once
through ``parallel/streams.py:run_parallel_streams``, every process on
card 0 (``streams_per_chip`` the group's size); then each stream again,
alone on the card in its own process while the others wait at a barrier:
the same items through a ``Prefetcher``, the same dropout seeds
(``stream_video_seed``), the engine reset and stepped directly.

A stream is TANet float32 at the reference operating point
(``tanet_ucf101_preset``: 101 classes, 2 views x 16 x 224², mean_var,
``tta_online``), seeded weights (the same in every process) and its own
seeded synthetic uint8 videos, cuDNN's deterministic algorithms, TF32 off.
A run is VIDEOS videos: the last is profiled (torch.profiler: the
process's own kernels), the ones before it after WARMUP are timed.  Each process
writes ``OUT/stream_<r>_<paired|alone>.pt``: per video the losses, eval
logits, top-1 and the host clock at its start; the final parameters and
EMA; the profiled step's device-busy and wall ms; peak memory; the kernel
wrappers' launch counts and the libraries' own over the run; the card's
name.  Needs a CUDA device (``VITTA_PLATFORM=cpu`` runs it on the CPU,
where nothing is profiled).  ``chip_smoke.py`` compares the files.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

T, HW, CLASSES = 16, 224, 101
VIDEOS, WARMUP, SEED = 10, 1, 0
LOSSES = ("loss_reg", "loss_consis", "loss_ce")


class SyntheticStream:
    """Stream ``stream``'s ``n`` videos, each made on demand from
    (``seed``, stream, index): uint8 views (2, T, S, S, 3), eval clip
    (1, T, S, S, 3), label."""

    def __init__(self, seed: int, stream: int, n: int):
        self.seed, self.stream, self.n = seed, stream, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng([self.seed, self.stream, i])
        shape = (T, HW, HW, 3)
        return (rng.integers(0, 256, (2, *shape), dtype=np.uint8),
                rng.integers(0, 256, (1, *shape), dtype=np.uint8),
                np.asarray([int(rng.integers(CLASSES))], np.int64))


class Recorder:
    """Wraps an engine's ``adapt_eval_step`` and ``eval_logits`` on the
    instance: per step the host clock at its start, its losses, top-1 and
    eval logits; step ``profile_at`` runs under torch.profiler."""

    def __init__(self, engine, profile_at: int):
        self.starts, self.losses, self.top1, self.logits = [], [], [], []
        self.busy_ms = self.profiled_ms = None
        step, logits = engine.adapt_eval_step, engine.eval_logits
        cuda = engine.device.type == "cuda"

        def eval_logits(*a, **k):
            out = logits(*a, **k)
            self.logits.append(out.detach().cpu())
            return out

        def adapt_eval_step(*a, **k):
            self.starts.append(time.perf_counter())
            if len(self.starts) - 1 == profile_at and cuda:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    state, m = step(*a, **k)
                    torch.cuda.synchronize()
                    self.profiled_ms = (time.perf_counter() - t0) * 1e3
                self.busy_ms = sum(e.self_device_time_total
                                   for e in prof.key_averages()) / 1e3
            else:
                state, m = step(*a, **k)
            self.losses.append([float(getattr(m, f)) for f in LOSSES])
            self.top1.append(float(m.top1))
            return state, m

        engine.eval_logits = eval_logits
        engine.adapt_eval_step = adapt_eval_step
        self._engine = engine

    def close(self):
        """Give the engine its own methods back."""
        del self._engine.eval_logits, self._engine.adapt_eval_step


def _run(engine, data, stream, alone, out):
    """One run of ``stream`` (all the group's streams at once, or this one
    alone), recorded to ``out``."""
    from vitta_tpu_torch.data.pipeline import Prefetcher
    from vitta_tpu_torch.ops import cuda_stats, cuda_tam
    from vitta_tpu_torch.ops._launch import library_launches
    from vitta_tpu_torch.parallel.streams import (run_parallel_streams,
                                                  stream_video_seed)

    rec = Recorder(engine, profile_at=VIDEOS - 1)
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    cuda_tam.counters.reset()
    cuda_stats.counters.reset()
    before = library_launches()
    if alone:
        state = engine.init_state()
        for bi, (views, clip, label) in enumerate(Prefetcher(
                data[stream], device=engine.device)):
            engine.generator.manual_seed(
                stream_video_seed(SEED, stream, VIDEOS, bi))
            state, _m = engine.adapt_eval_step(state, views, clip, label)
    else:
        _rows, state = run_parallel_streams(engine, data, seed=SEED)
    end = time.perf_counter()
    after = library_launches()
    rec.close()
    torch.save({
        "stream": stream, "n_streams": len(data), "warmup": WARMUP,
        "starts": rec.starts, "end": end, "losses": rec.losses,
        "top1": rec.top1, "logits": rec.logits,
        "params": {k: p.detach().cpu() for k, p in state.params.items()},
        "ema": {k: tuple(t.cpu() for t in v) for k, v in state.ema.items()},
        "busy_ms": rec.busy_ms, "profiled_ms": rec.profiled_ms,
        "peak_gib": (torch.cuda.max_memory_allocated(engine.device) / 2**30
                     if cuda else None),
        "launches": {"tam_fwd": cuda_tam.counters.fwd,
                     "tam_bwd": cuda_tam.counters.bwd,
                     "bn_stats_fwd": cuda_stats.counters.fwd,
                     "bn_stats_bwd": cuda_stats.counters.bwd},
        "library": {k: n - before.get(k, 0) for k, n in after.items()
                    if n != before.get(k, 0)},
        "chosen": len(engine.tap_names),
        "device": (torch.cuda.get_device_name(engine.device) if cuda
                   else "cpu"),
        "cores": len(os.sched_getaffinity(0)),
    }, out)


def main(argv=None) -> None:
    from vitta_tpu_torch.parallel.mesh import (coordination_barrier,
                                               initialize_distributed,
                                               local_rank, rank,
                                               stream_device)
    from vitta_tpu_torch.tools.tanet_breakdown import tanet_cfg, tanet_engine

    out = (sys.argv[1:] if argv is None else argv)[0]
    world = initialize_distributed()
    me = rank()
    device = stream_device(local_rank(), world)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine, _rng = tanet_engine(tanet_cfg(T, CLASSES), SEED, hw=HW,
                                device=device)
    data = [SyntheticStream(SEED, i, VIDEOS) for i in range(world)]
    os.makedirs(out, exist_ok=True)
    coordination_barrier("parallel_streams_start")
    _run(engine, data, me, False, os.path.join(out, f"stream_{me}_paired.pt"))
    for turn in range(world):
        coordination_barrier(f"parallel_streams_alone_{turn}")
        if turn == me:
            _run(engine, data, me, True,
                 os.path.join(out, f"stream_{me}_alone.pt"))
    coordination_barrier("parallel_streams_end")


if __name__ == "__main__":
    main()
