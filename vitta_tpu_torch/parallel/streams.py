"""Stream-parallel test-time adaptation, one process per stream.

The PyTorch counterpart of vitta_tpu/parallel/streams.py.  The ViTTA
stream is sequential per video (the EMA and optimizer state carry across
steps), so scaling comes from adapting several *corruption streams* at
once.  vitta_tpu stacks the streams' states on a mesh axis and runs the
vmapped step under ``shard_map``; the port runs one process per stream
(``torchrun``, ``parallel/mesh.py``): rank ``r`` owns stream ``r`` of a
group, with its own ``VittaEngine``, state and device, and the step has
no communication at all.  The processes meet once a video, in the host-side
gather of the streams' metrics, which also keeps them in lock step, and at
the checkpoint barriers.  Several processes may share one card
(``streams_per_chip``), which a host-bound step needs to keep the card
busy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vitta_tpu_torch.adapt.engine import TTAState, VittaEngine
from vitta_tpu_torch.adapt.loops import video_seed
from vitta_tpu_torch.parallel.mesh import rank, world_size

# the per-video metrics a group gathers, in this order
METRICS = ("loss_reg", "loss_consis", "loss_ce", "top1", "top5")


def stream_video_seed(seed: int, stream: int, n_videos: int,
                      index: int) -> int:
    """Dropout seed of video ``index`` of stream ``stream`` in a group of
    ``n_videos``-long streams: vitta_tpu folds ``stream * n_videos +
    index`` into the run's key (vitta_tpu/parallel/streams.py:148), the
    port hands the same number to ``loops.video_seed``."""
    return video_seed(seed, stream * n_videos + index)


class StreamParallelEngine:
    """This process's stream of a group of ``n_streams``.

    Rank ``r`` runs stream ``r``; the ranks at or past ``n_streams`` are
    idle (their state is None) but join every gather, so a group smaller
    than the world still meets in lock step."""

    def __init__(self, engine: VittaEngine, n_streams: int):
        self.engine = engine
        self.n_streams = n_streams
        self.world = world_size()
        self.index = rank()
        if n_streams > self.world:
            raise ValueError(
                f"{n_streams} streams need {n_streams} processes, one a "
                f"stream; the group has {self.world}")
        self.active = self.index < n_streams

    def init_state(self) -> Optional[TTAState]:
        return self.engine.init_state() if self.active else None

    def adapt_eval_step(self, state, views, eval_clip, label):
        """This stream's adapt+eval step, ``(state, StepMetrics)``;
        ``(state, None)`` on an idle rank.  Under ``tta_standard`` the
        engine resets the state but keeps its step, as vitta_tpu's
        stream-parallel step does (streams.py:106-107)."""
        if not self.active:
            return state, None
        return self.engine.adapt_eval_step(state, views, eval_clip, label)

    def gather_metrics(self, t) -> np.ndarray:
        """Every stream's ``t`` (a tensor or array of one shape on every
        active rank; None on an idle one), stacked in stream order as a
        float64 ``(S, ...)`` array on every rank: vitta_tpu's replicated
        gather (streams.py:80-98), through the group's host collective."""
        value = (None if t is None else np.asarray(
            torch.as_tensor(t).detach().cpu(), np.float64))
        got = [value]
        if self.world > 1:
            got = [None] * self.world
            dist.all_gather_object(got, value)
        return np.stack(got[:self.n_streams])


def _step_vector(m) -> torch.Tensor:
    return torch.stack([getattr(m, k).to(torch.float32) for k in METRICS])


def run_parallel_streams(engine: VittaEngine, stream_datasets, seed: int = 0,
                         logger=None, checkpointer=None, n_workers: int = 1):
    """Adapt a group of corruption streams in lock step, one a process.

    ``stream_datasets``: one paired dataset a stream (the same video list
    under different corruptions), all of one length; this rank reads only
    its own, through a ``Prefetcher`` of ``n_workers`` onto the engine's
    device.  Returns ``(per-stream top-1 averages in stream order, this
    rank's final state)``; every rank gets the same averages.

    ``checkpointer`` (adapt/stream_ckpt.StreamCheckpointer) saves each
    stream's state every N videos, with the group's meters as per-stream
    vectors; a restart resumes the group mid-stream on the uninterrupted
    trajectory (each video's dropout seed is ``stream_video_seed`` of its
    absolute index)."""
    from vitta_tpu_torch.data.pipeline import Prefetcher

    n = len(stream_datasets)
    lengths = {len(d) for d in stream_datasets}
    if len(lengths) != 1:
        raise ValueError(f"streams must have equal length, got {lengths}")
    n_videos = lengths.pop()
    spe = StreamParallelEngine(engine, n)
    state = spe.init_state()
    sums = np.zeros((n, len(METRICS)))
    count = 0
    start = 0
    generator = engine.generator if spe.active else None
    if checkpointer is not None:
        got = checkpointer.restore(state, generator=generator)
        if got is not None:
            state, start, meters = got
            sums = np.stack([np.asarray(meters[k][0], np.float64)
                             for k in METRICS], axis=1)
            count = meters["top1"][1]
            if logger:
                logger.info(f"resume: parallel group mid-stream at video "
                            f"{start}")
    items = (Prefetcher(stream_datasets[spe.index], device=engine.device,
                        n_workers=n_workers, start=start)
             if spe.active else [None] * (n_videos - start))
    for bi, item in enumerate(items, start=start):
        vec = None
        if spe.active:
            views, clip, label = item
            engine.generator.manual_seed(
                stream_video_seed(seed, spe.index, n_videos, bi))
            state, m = spe.adapt_eval_step(state, views, clip, label)
            vec = _step_vector(m)
        sums += spe.gather_metrics(vec)
        count += 1
        if logger and bi % 20 == 0:
            logger.debug(f"parallel-TTA [{bi}/{n_videos}] top1 "
                         f"{sums[:, METRICS.index('top1')] / count}")
        if checkpointer is not None and (bi + 1) % checkpointer.every == 0:
            checkpointer.save(state, bi + 1,
                              {k: (sums[:, j], count)
                               for j, k in enumerate(METRICS)},
                              generator=generator)
    if checkpointer is not None:
        checkpointer.clear()
    top1 = sums[:, METRICS.index("top1")] / max(count, 1)
    return top1.tolist(), state
