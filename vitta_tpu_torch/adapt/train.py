"""Supervised source training — the PyTorch counterpart of
vitta_tpu/adapt/train.py (reference corpus/main_train.py:23-122,
corpus/basics.py:35-93):

* SGD (momentum 0.9, weight decay 5e-4) with a step-decay learning rate
  (x0.1 at each of ``lr_steps`` epochs, utils/utils_.py:214-221) and
  optional gradient-norm clipping (basics.py:70-76).  vitta_tpu chains
  optax's transforms: clip by global norm, add the decayed weights, the
  momentum trace, times ``-lr(count)``.  ``clip_grad_norm_`` followed by
  ``torch.optim.SGD(momentum, weight_decay, dampening=0)`` applies the same
  updates in the same order: d = g + wd * p, v = momentum * v + d (v = d at
  the first step, as optax's trace starts from 0), p -= lr * v;
* BatchNorm layers in batch-statistics mode, updating their running
  statistics (unbiased running variance, ``models/layers.py:BatchNorm``);
* dropout drawn from the trainer's ``torch.Generator``, reseeded per batch
  from the epoch's seed and the batch's index;
* checkpoints of the whole training state on ``torch.save`` (and a
  ``<path>_best`` copy for the best one, utils_.py:240-249).

Like ``VittaEngine``, the trainer owns one live model and updates it in
place: a ``TrainState`` names its parameters, buffers and optimizer.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from vitta_tpu_torch.adapt.engine import resolve_device
from vitta_tpu_torch.adapt.loops import video_seed
from vitta_tpu_torch.ops.losses import cross_entropy, topk_accuracy
from vitta_tpu_torch.utils.meters import AverageMeter


@dataclasses.dataclass
class TrainState:
    """The live model's ``params`` and ``batch_stats`` (its buffers), the
    ``optimizer`` that holds the momentum, and ``step``: the updates
    applied so far."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int


def step_decay_schedule(base_lr: float, lr_steps: Sequence[int],
                        steps_per_epoch: int) -> Callable[[int], float]:
    """``count -> lr``: ``base_lr`` times 0.1 for each boundary
    ``e * steps_per_epoch`` (``e`` in ``lr_steps``) that ``count``, the
    updates already applied, has reached (``count >= boundary``), as
    ``optax.piecewise_constant_schedule`` with vitta_tpu's boundaries does;
    equal boundaries count once, as in its dict."""
    boundaries = sorted({int(e * steps_per_epoch) for e in lr_steps})

    def schedule(count: int) -> float:
        return base_lr * 0.1 ** sum(count >= b for b in boundaries)

    return schedule


class Trainer:
    """Trains ``model`` (TANet, or any model of the port's forward
    signature) on ``device``: the card unless the CPU is asked for."""

    def __init__(self, model, lr: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 5e-4,
                 lr_steps: Sequence[int] = (30, 60),
                 steps_per_epoch: int = 1000,
                 clip_gradient: Optional[float] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.schedule = step_decay_schedule(lr, lr_steps, steps_per_epoch)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_gradient = clip_gradient
        self.generator = torch.Generator(device=self.device)

    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``state_dict`` (where given) into the model and start a
        fresh optimizer: no momentum, step 0."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.zero_grad(set_to_none=True)
        opt = torch.optim.SGD(self.model.parameters(), lr=self.schedule(0),
                              momentum=self.momentum, dampening=0.0,
                              weight_decay=self.weight_decay)
        return TrainState(dict(self.model.named_parameters()),
                          dict(self.model.named_buffers()), opt, 0)

    def train_step(self, state: TrainState, clips, labels,
                   generator: Optional[torch.Generator] = None):
        """One SGD step on ``clips`` (B, T, H, W, 3) float and ``labels``
        (B,); returns ``(state, (loss, top1, top5))``, the metrics of the
        batch's logits before the update, left on the device."""
        generator = self.generator if generator is None else generator
        x = torch.as_tensor(clips).to(self.device, non_blocking=True)
        y = torch.as_tensor(labels).to(self.device).long()
        self.model.zero_grad(set_to_none=True)
        out = self.model(x, None, train=True, generator=generator,
                         use_running_average=False, update_running_stats=True)
        loss = cross_entropy(out, y)
        loss.backward()
        if self.clip_gradient is not None:
            torch.nn.utils.clip_grad_norm_(state.params.values(),
                                           self.clip_gradient)
        for group in state.optimizer.param_groups:
            group["lr"] = self.schedule(state.step)
        state.optimizer.step()
        top1, top5 = topk_accuracy(out.detach(), y)
        return (dataclasses.replace(state, step=state.step + 1),
                (loss.detach(), top1, top5))

    def train_epoch(self, state: TrainState, data_iter, seed: int = 0,
                    logger=None, print_freq: int = 20
                    ) -> Tuple[TrainState, dict]:
        """``train_step`` over ``(clips, labels)`` batches, batch ``bi``'s
        dropout seeded with ``video_seed(seed, bi)``; returns the state and
        the epoch's mean loss and top-1."""
        losses, top1 = AverageMeter(), AverageMeter()
        for bi, (clips, labels) in enumerate(data_iter):
            self.generator.manual_seed(video_seed(seed, bi))
            state, (loss, t1, _t5) = self.train_step(state, clips, labels)
            losses.update(float(loss), n=labels.shape[0])
            top1.update(float(t1), n=labels.shape[0])
            if logger and bi % print_freq == 0:
                logger.debug(f"train [{bi}] loss {losses.val:.4f} "
                             f"({losses.avg:.4f}) top1 {top1.avg:.2f}")
        return state, {"loss": losses.avg, "top1": top1.avg}


# ---------------------------------------------------------------------------
# Checkpoint save / resume
# ---------------------------------------------------------------------------

def _payload(state):
    if isinstance(state, TrainState):
        return {"params": {k: p.detach() for k, p in state.params.items()},
                "batch_stats": dict(state.batch_stats),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}
    return state


def save_checkpoint(path: str, state, keep_best: bool = False,
                    is_best: bool = False) -> None:
    """Save ``state`` (a ``TrainState``, or a dict of tensors and numbers
    such as a state dict) to ``path`` with ``torch.save``, replacing the
    file only once it is complete; with ``keep_best`` and ``is_best`` also
    copy it to ``<path>_best`` (utils_.py:240-249)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(_payload(state), tmp)
    os.replace(tmp, path)
    if keep_best and is_best:
        shutil.copyfile(path, path + "_best")


def restore_checkpoint(path: str, target=None):
    """What ``save_checkpoint`` wrote to ``path``, read with
    ``torch.load(weights_only=True)``.  With ``target`` a ``TrainState``,
    the saved parameters, buffers and momentum are copied into the live
    tensors it names and the restored ``TrainState`` is returned."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if not isinstance(target, TrainState):
        return saved
    with torch.no_grad():
        for k, p in target.params.items():
            p.copy_(saved["params"][k])
        for k, b in target.batch_stats.items():
            b.copy_(saved["batch_stats"][k])
    target.optimizer.load_state_dict(saved["optimizer"])
    return dataclasses.replace(target, step=saved["step"])
