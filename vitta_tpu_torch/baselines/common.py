"""Shared helpers for the baseline methods (vitta_tpu/baselines/common.py)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from vitta_tpu_torch.adapt.engine import resolve_device
from vitta_tpu_torch.ops.losses import topk_accuracy
from vitta_tpu_torch.utils.meters import AverageMeter


def batched_eval_iter(dataset, batch_size: int
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (clips (B*E, T, S, S, 3), labels (B,)) batches from an eval
    dataset of per-video samples (last partial batch included — the
    reference DataLoader does not drop_last)."""
    buf_x, buf_y = [], []
    for i in range(len(dataset)):
        s = dataset[i]
        buf_x.append(s.frames)
        buf_y.append(s.label)
        if len(buf_x) == batch_size:
            yield np.concatenate(buf_x, 0), np.asarray(buf_y, np.int64)
            buf_x, buf_y = [], []
    if buf_x:
        yield np.concatenate(buf_x, 0), np.asarray(buf_y, np.int64)


def eval_views_of(cfg) -> int:
    """Eval clips per video: crops times clips (TANet's clips from its
    ``sample_style``)."""
    if cfg.model.arch == "tanet":
        return cfg.data.test_crops * int(cfg.data.sample_style.split("-")[-1])
    return cfg.data.test_crops * cfg.data.num_clips


class BaselineBase:
    """A baseline owns ``model`` on ``device`` (the card unless the CPU is
    asked for) and loads ``state_dict`` into it at the start of every
    ``run``, so that each run starts from the given weights.  Where
    vitta_tpu threads immutable variables through jitted steps, a baseline
    here updates the live module: its parameters through a ``torch.optim``
    optimizer, its BatchNorm running statistics in place."""

    def __init__(self, model, cfg, state_dict, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.state_dict = state_dict
        self.n_eval_views = eval_views_of(cfg)
        self.reset()

    def reset(self) -> None:
        """The model back to ``state_dict``, its gradients cleared."""
        self.model.load_state_dict(self.state_dict, strict=True)
        self.model.zero_grad(set_to_none=True)

    def _to_device(self, clips) -> torch.Tensor:
        return torch.as_tensor(clips).to(self.device, non_blocking=True)

    def _mean_logits(self, logits):
        e = self.n_eval_views
        b = logits.shape[0] // e
        return torch.mean(logits.reshape(b, e, -1), dim=1)

    def _classifier(self):
        """The model's ``classify``; only TANet has one (Video Swin's
        Recognizer3D has none in vitta_tpu either)."""
        if not hasattr(self.model, "classify"):
            raise NotImplementedError(
                f"{type(self).__name__} needs the model's features and "
                f"classifier apart; {type(self.model).__name__} has no "
                "classify (vitta_tpu runs this baseline on TANet only)")
        return self.model.classify

    def evaluate(self, apply_fn, dataset, batch_size: int = 1) -> float:
        """Top-1 (percent) of ``apply_fn(clips) -> logits`` over
        ``dataset``, the eval views of each video averaged."""
        top1 = AverageMeter()
        for clips, labels in batched_eval_iter(dataset, batch_size):
            with torch.no_grad():
                logits = apply_fn(self._to_device(clips))
            mean = self._mean_logits(logits)
            t1, _ = topk_accuracy(mean, self._to_device(labels))
            top1.update(float(t1), n=labels.shape[0])
        return top1.avg
