"""Data-parallel evaluation over the processes of a group.

The PyTorch counterpart of vitta_tpu/parallel/data_eval.py.  Evaluation is
embarrassingly parallel over videos: vitta_tpu shards a batch's leading
axis over the mesh's ``data`` axis and XLA reduces the metrics; here each
process of the gloo group (``parallel/mesh.py``) evaluates its share of
every batch on its own device, and the correct counts are summed by an
``all_reduce`` on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from vitta_tpu_torch.baselines.common import batched_eval_iter, eval_views_of
from vitta_tpu_torch.parallel.mesh import (local_rank, rank, stream_device,
                                           world_size)
from vitta_tpu_torch.utils.meters import AverageMeter


def _percent(correct: int, n: int, device) -> float:
    """``topk_accuracy``'s value for ``correct`` hits among ``n`` videos:
    the same float32 mean of 0 / 1 hits on the same device, times 100.
    ``torch.mean`` scales the sum by 1 / n, which can round an ulp away
    from ``correct / n``; the source baseline's averages are of these
    values, so the percentage is made the same way to equal them bit for
    bit."""
    hits = torch.zeros(n, dtype=torch.float32, device=device)
    hits[:correct] = 1.0
    return float(100.0 * torch.mean(hits))


def sharded_validate(model, dataset, cfg, batch_size: Optional[int] = None,
                     logger=None, device=None) -> Tuple[float, float]:
    """Top-1 / top-5 (percent) of ``model`` over ``dataset`` (eval items:
    ``frames`` (E, T, S, S, 3), ``label``), each batch split over the
    group's processes.

    ``batch_size`` defaults to one video a process and is rounded down to a
    multiple of the group's size (at least one video a process); a last
    batch that does not split evenly is evaluated by rank 0 alone, as
    vitta_tpu evaluates it on one device (data_eval.py:30-49).  Each rank
    runs on ``device``, by default its stream device
    (``stream_device(local_rank(), cfg.runtime.streams_per_chip)``: the
    card unless ``VITTA_PLATFORM=cpu``).  Each batch's correct counts are
    summed over the ranks, so every rank returns the same averages, equal
    to the source-only baseline's on one device."""
    world, me = world_size(), rank()
    if device is None:
        device = stream_device(local_rank(), cfg.runtime.streams_per_chip)
    device = torch.device(device)
    model = model.to(device)
    batch_size = batch_size or world
    batch_size = max(world, (batch_size // world) * world)
    e = eval_views_of(cfg)
    top1, top5 = AverageMeter(), AverageMeter()
    for bi, (clips, labels) in enumerate(batched_eval_iter(dataset,
                                                           batch_size)):
        n = labels.shape[0]
        if n % world == 0:
            share = n // world
            lo, hi = me * share, (me + 1) * share
        else:   # the remainder batch: rank 0 alone
            lo, hi = (0, n) if me == 0 else (0, 0)
        counts = torch.zeros(2, dtype=torch.int64)   # top-1, top-5 hits
        if hi > lo:
            x = torch.as_tensor(clips[lo * e:hi * e]).to(device)
            y = torch.as_tensor(labels[lo:hi]).to(device)
            with torch.no_grad():
                logits = model(x, None, train=False)
            mean = logits.reshape(hi - lo, e, -1).mean(dim=1)
            # topk_accuracy's ranking: the label among the top 1 / top 5
            pred = torch.topk(mean, min(5, mean.shape[-1]), dim=-1).indices
            hits = (pred == y[:, None]).cpu()
            counts[0] = hits[:, 0].sum()
            counts[1] = hits.sum()
        if world > 1:
            dist.all_reduce(counts)
        top1.update(_percent(int(counts[0]), n, device), n=n)
        top5.update(_percent(int(counts[1]), n, device), n=n)
        if logger and bi % 20 == 0:
            logger.debug(f"sharded eval [{bi}] top1 {top1.avg:.3f}")
    return top1.avg, top5.avg
