"""Host-side adaptation / evaluation loops.

The PyTorch counterpart of vitta_tpu/adapt/loops.py:26-138 (reference
corpus/basics.py ``tta_standard`` 403-747, ``test_time_adapt`` 760-1084,
``validate`` 96-217): iterate the video stream, run the engine's steps,
aggregate meters.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from vitta_tpu_torch.adapt.engine import TTAState, VittaEngine
from vitta_tpu_torch.utils.meters import AverageMeter


def video_seed(seed: int, index: int) -> int:
    """Dropout seed of the stream's ``index``-th video: a function of the
    stream's seed and the video's index, as the JAX loop folds the index
    into its key.  Both reach the low 32 bits, which are all that torch's
    CPU generator reads of a seed."""
    return ((seed * 1000003) ^ index) & (2 ** 63 - 1)


def _preload_meter(meter: AverageMeter, sum_count) -> AverageMeter:
    meter.sum, meter.count = sum_count
    meter.avg = meter.sum / max(meter.count, 1)
    return meter


def tta_stream(engine: VittaEngine, paired_data, seed: int = 0,
               state: Optional[TTAState] = None,
               metrics_writer=None, *, logger=None, print_freq: int = 20,
               checkpointer=None, start_index: int = 0,
               meter_state: Optional[dict] = None
               ) -> Tuple[list, TTAState, dict]:
    """Run the online TTA loop over one corruption stream.

    ``paired_data`` yields (tta_views (V,T,S,S,3), eval_clip (E,T,S,S,3),
    label (1,)) per video, as numpy arrays or tensors.  Returns
    ([top1_avg], final_state, meters) — the reference returns
    ``[top1.avg]`` (basics.py:740-747).  ``metrics_writer.scalar(tag,
    value, step)`` receives each video's losses, top-1 and step time;
    ``logger`` a line every ``print_freq`` videos.

    Mid-stream resume (vitta_tpu/adapt/loops.py:26-107): pass
    ``checkpointer`` (adapt/stream_ckpt.StreamCheckpointer) to save the
    carried state every ``checkpointer.every`` videos; on restart the caller
    restores (state, start_index, meter_state) from it and feeds a
    ``paired_data`` that begins at ``start_index`` (``Prefetcher(start=)``).
    Each video's dropout seed is ``video_seed(seed, index)`` of its absolute
    index, so the resumed trajectory is the uninterrupted one."""
    if state is None:
        state = engine.init_state()
    top1, top5 = AverageMeter(), AverageMeter()
    losses_reg, losses_consis, losses_ce = (AverageMeter(), AverageMeter(),
                                            AverageMeter())
    meters = dict(top1=top1, top5=top5, loss_reg=losses_reg,
                  loss_consis=losses_consis, loss_ce=losses_ce)
    for name, meter in meters.items():
        # the loss meters are part of the resumed trajectory too;
        # batch_time is this process's wall clock and restarts
        if meter_state and name in meter_state:
            _preload_meter(meter, meter_state[name])
    batch_time = AverageMeter()
    end = time.time()
    for bi, (views, clip, label) in enumerate(paired_data, start=start_index):
        engine.generator.manual_seed(video_seed(seed, bi))
        state, m = engine.adapt_eval_step(state, views, clip, label)
        # reading the metrics waits for the device
        top1.update(float(m.top1), n=label.shape[0])
        top5.update(float(m.top5), n=label.shape[0])
        losses_reg.update(float(m.loss_reg))
        losses_consis.update(float(m.loss_consis))
        losses_ce.update(float(m.loss_ce))
        batch_time.update(time.time() - end)
        end = time.time()
        if metrics_writer is not None:
            metrics_writer.scalar("tta/loss_reg", losses_reg.val, bi)
            metrics_writer.scalar("tta/loss_consis", losses_consis.val, bi)
            metrics_writer.scalar("tta/top1_avg", top1.avg, bi)
            metrics_writer.scalar("tta/step_ms", batch_time.val * 1000, bi)
        if logger and bi % print_freq == 0:
            logger.debug(
                f"TTA [{bi}] time {batch_time.val:.3f} ({batch_time.avg:.3f}) "
                f"reg {losses_reg.val:.4f} ({losses_reg.avg:.4f}) "
                f"consis {losses_consis.val:.4f} ({losses_consis.avg:.4f}) "
                f"top1 {top1.val:.3f} ({top1.avg:.3f})")
        if checkpointer is not None and (bi + 1) % checkpointer.every == 0:
            checkpointer.save(state, bi + 1,
                              {k: (v.sum, v.count) for k, v in meters.items()},
                              generator=engine.generator)
    if checkpointer is not None:
        checkpointer.clear()
    meters["batch_time"] = batch_time
    return [top1.avg], state, meters


def tta_epoch_adapt(engine: VittaEngine, tta_data, eval_data,
                    n_epochs: int = 1, seed: int = 0,
                    logger=None) -> Tuple[float, TTAState]:
    """Epoch-style legacy adaptation (``test_time_adapt``,
    corpus/basics.py:760-1084): adapt over the whole stream for
    ``n_epochs`` with ``adapt_step``, then a single evaluation pass with
    the adapted parameters (``validate_brief``, basics.py:1105-1189).
    ``tta_data`` yields (views, eval clip or None, label) tuples, or items
    with ``frames`` and ``label``; the step's dropout seed is
    ``video_seed(seed, ep * 100003 + bi)``."""
    state = engine.init_state()
    for ep in range(n_epochs):
        for bi, item in enumerate(tta_data):
            views, _clip, label = item if isinstance(item, tuple) else (
                item.frames, None, np.asarray([item.label], np.int64))
            engine.generator.manual_seed(video_seed(seed, ep * 100003 + bi))
            state, losses = engine.adapt_step(state, views, label)
            if logger and bi % 20 == 0:
                logger.debug(f"epoch-TTA [{ep}][{bi}] reg "
                             f"{float(losses[0]):.4f}")
    top1, _top5 = validate(engine, eval_data, params=state.params)
    return top1, state


def validate(engine: VittaEngine, data, params=None) -> Tuple[float, float]:
    """Plain evaluation loop (reference basics.py:96-217 without the
    baseline adaptation pre-passes).  ``data`` yields (clip, label) pairs,
    or items with ``frames`` and ``label`` (a dataset's ``Sample``), as
    vitta_tpu/adapt/loops.py:127-130 takes them.  ``params`` defaults to
    the engine's initial weights."""
    top1, top5 = AverageMeter(), AverageMeter()
    for item in data:
        clip, label = ((item.frames, np.asarray([item.label], np.int64))
                       if hasattr(item, "frames") else item)
        t1, t5, _pred = engine.eval_step(
            engine.init_params if params is None else params, clip, label)
        top1.update(float(t1), n=label.shape[0])
        top5.update(float(t5), n=label.shape[0])
    return top1.avg, top5.avg
