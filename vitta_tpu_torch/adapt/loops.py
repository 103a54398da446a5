"""Host-side adaptation / evaluation loops.

The PyTorch counterpart of vitta_tpu/adapt/loops.py:26-138 (reference
corpus/basics.py ``tta_standard`` 403-747, ``validate`` 96-217): iterate
the video stream, run the engine's steps, aggregate meters.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from vitta_tpu_torch.adapt.engine import TTAState, VittaEngine
from vitta_tpu_torch.utils.meters import AverageMeter


def video_seed(seed: int, index: int) -> int:
    """Dropout seed of the stream's ``index``-th video: a function of the
    stream's seed and the video's index, as the JAX loop folds the index
    into its key.  Both reach the low 32 bits, which are all that torch's
    CPU generator reads of a seed."""
    return ((seed * 1000003) ^ index) & (2 ** 63 - 1)


def tta_stream(engine: VittaEngine, paired_data, seed: int = 0,
               state: Optional[TTAState] = None,
               metrics_writer=None) -> Tuple[list, TTAState, dict]:
    """Run the online TTA loop over one corruption stream.

    ``paired_data`` yields (tta_views (V,T,S,S,3), eval_clip (E,T,S,S,3),
    label (1,)) per video, as numpy arrays or tensors.  Returns
    ([top1_avg], final_state, meters) — the reference returns
    ``[top1.avg]`` (basics.py:740-747).  ``metrics_writer.scalar(tag,
    value, step)`` receives each video's losses, top-1 and step time.
    Mid-stream checkpointing and resume are not ported yet."""
    if state is None:
        state = engine.init_state()
    top1, top5 = AverageMeter(), AverageMeter()
    losses_reg, losses_consis, losses_ce = (AverageMeter(), AverageMeter(),
                                            AverageMeter())
    batch_time = AverageMeter()
    end = time.time()
    for bi, (views, clip, label) in enumerate(paired_data):
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
    meters = dict(top1=top1, top5=top5, loss_reg=losses_reg,
                  loss_consis=losses_consis, loss_ce=losses_ce,
                  batch_time=batch_time)
    return [top1.avg], state, meters


def validate(engine: VittaEngine, data, params=None) -> Tuple[float, float]:
    """Plain evaluation loop (reference basics.py:96-217 without the
    baseline adaptation pre-passes).  ``params`` defaults to the engine's
    initial weights."""
    top1, top5 = AverageMeter(), AverageMeter()
    for clip, label in data:
        t1, t5, _pred = engine.eval_step(
            engine.init_params if params is None else params, clip, label)
        top1.update(float(t1), n=label.shape[0])
        top5.update(float(t5), n=label.shape[0])
    return top1.avg, top5.avg
