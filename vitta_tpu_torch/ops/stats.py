"""Feature-statistic computation — the functional core of ViTTA.

The PyTorch counterpart of vitta_tpu/ops/stats.py, with the same
semantics (reference utils/norm_stats_utils.py:18-258 and
utils/utils_.py:190-211):

* ``channel_stats``: per-channel mean and *biased* variance of a
  channels-last ``(..., C)`` tensor, over all non-channel axes
  ("spatiotemp") or the partial reductions of "spatial" / "temp" /
  "temp_v2".  Variance is the one-pass ``E[x^2] - E[x]^2`` in float32,
  as in the JAX package (not ``torch.var``'s two-pass form), so the two
  agree to float32 rounding.
* ``ema_update`` (``MovingAverageTensor``) and ``cumulative_update``
  (``AverageMeterTensor``): the carried state is ``detach``ed where JAX
  has ``stop_gradient``, so the gradient flows only through the current
  batch's contribution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class TapStats(NamedTuple):
    """Per-layer channel statistics captured at a tap point."""

    mean: torch.Tensor  # (C,) for 'spatiotemp'
    var: torch.Tensor   # (C,) biased variance


def _mean_var(x: torch.Tensor, dims) -> TapStats:
    mean = torch.mean(x, dim=dims)
    mean_sq = torch.mean(torch.square(x), dim=dims)
    return TapStats(mean, mean_sq - torch.square(mean))


def channel_stats(x: torch.Tensor, channel_axis: int = -1,
                  stat_type: str = "spatiotemp",
                  time_axis: Optional[int] = None) -> TapStats:
    """Channel mean/biased-variance of a channels-last feature tensor.

    ``spatiotemp`` reduces every non-channel axis; ``spatial`` keeps
    (C, T) and needs ``time_axis``; ``temp`` keeps (C, H, W), reducing
    over batch and ``time_axis`` only; ``temp_v2`` first averages the
    spatial axes, then reduces over (N, T)."""
    x = x.to(torch.float32)
    ndim = x.dim()
    caxis = channel_axis % ndim
    if stat_type == "spatiotemp":
        return _mean_var(x, tuple(a for a in range(ndim) if a != caxis))
    if time_axis is None:
        raise ValueError(f"stat_type={stat_type!r} needs time_axis")
    taxis = time_axis % ndim
    if stat_type == "spatial":
        mean, var = _mean_var(
            x, tuple(a for a in range(ndim) if a not in (caxis, taxis)))
        # reference ordering is (C, T)
        if caxis > taxis:
            mean, var = mean.T, var.T
        return TapStats(mean, var)
    if stat_type == "temp":
        mean, var = _mean_var(x, (0, taxis) if taxis != 0 else (0,))
        # reference layout is (C, H, W) (norm_stats_utils.py:86-89)
        return TapStats(torch.movedim(mean, -1, 0), torch.movedim(var, -1, 0))
    if stat_type == "temp_v2":
        spatial = tuple(a for a in range(ndim)
                        if a not in (caxis, taxis) and a != 0)
        xs = torch.mean(x, dim=spatial)
        caxis2 = sum(1 for a in (0, taxis) if a < caxis)
        return _mean_var(xs, tuple(a for a in range(xs.dim()) if a != caxis2))
    raise NotImplementedError(f"stat_type={stat_type}")


def ema_update(ema: TapStats, batch: TapStats, momentum: float) -> TapStats:
    """MovingAverageTensor.update (reference utils/utils_.py:210-211):
    ``avg = m*val + (1-m)*avg.detach()``."""
    return TapStats(
        momentum * batch.mean + (1.0 - momentum) * ema.mean.detach(),
        momentum * batch.var + (1.0 - momentum) * ema.var.detach(),
    )


class CumulativeState(NamedTuple):
    """AverageMeterTensor state (reference utils/utils_.py:190-202)."""

    sum_mean: torch.Tensor
    sum_var: torch.Tensor
    count: torch.Tensor  # scalar float


def cumulative_update(state: CumulativeState, batch: TapStats,
                      n) -> Tuple[CumulativeState, TapStats]:
    """``sum = sum.detach() + val*n; avg = sum/count`` per utils_.py:198-202."""
    new = CumulativeState(
        state.sum_mean.detach() + batch.mean * n,
        state.sum_var.detach() + batch.var * n,
        state.count + n,
    )
    return new, TapStats(new.sum_mean / new.count, new.sum_var / new.count)
