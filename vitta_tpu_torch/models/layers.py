"""BatchNorm with statistic taps, and channels-last conv helpers.

The PyTorch counterpart of vitta_tpu/models/layers.py:136-191.  The
reference registers forward hooks on its norm modules
(utils/norm_stats_utils.py, corpus/basics.py:565-600); here a tapped
forward fills a dict that the caller passes down, ``model(x, taps={})``,
and ``taps=None`` reduces nothing — the "hooks removed" eval path.

The dict maps each norm layer's name — exactly the JAX package's
flattened tap name, e.g. ``base_model.layer3_0.bn1`` — to its leaves:
``stat`` (output side), ``stat_in`` (input side), ``stat_<type>`` for the
other statistic types, and the count leaf ``stat_n``.  A plain dict
collects every leaf; a ``Taps`` with ``leaves`` set collects only those,
so the adaptation step pays for no reduction it does not read.

Layout: activations are channels-last ``(..., C)`` tensors, as in the JAX
package.  2D features are ``(N*T, H, W, C)`` and contiguous, which is the
``torch.channels_last`` memory of an ``(N*T, C, H, W)`` tensor, so a conv
takes a permuted view and returns one with no copy.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from vitta_tpu_torch.ops.stats import channel_stats

# Leaf carrying the reference's per-layer batch count ``bz`` — the ``n``
# of the cumulative meters (norm_stats_utils.py:177-182,244-249).
COUNT_LEAF = "stat_n"

# 'cossim' waits for the relation-map port (vitta_tpu/ops/relation.py).
STAT_TYPES = ("spatiotemp", "spatial", "temp", "temp_v2")


def tap_leaf_name(stat_type: str, input_side: bool = False) -> str:
    """Leaf name of a statistic type (vitta_tpu/models/layers.py:51)."""
    base = "stat_in" if input_side else "stat"
    return base if stat_type == "spatiotemp" else f"{base}_{stat_type}"


class Taps(dict):
    """A tap dict that collects only the named ``leaves``."""

    def __init__(self, leaves: Iterable[str]):
        super().__init__()
        self.leaves = frozenset(leaves)


def _wants(taps: dict, leaf: str) -> bool:
    leaves = getattr(taps, "leaves", None)
    return leaves is None or leaf in leaves


def flatten_taps(taps: dict, leaf: str = "stat") -> dict:
    """{name: value} of one leaf (vitta_tpu/adapt/engine.py:66)."""
    return {name: leaves[leaf] for name, leaves in taps.items()
            if leaf in leaves}


def record_typed_stats(taps: dict, name: str, x: torch.Tensor,
                       stat_types: Tuple[str, ...], clip_len: int,
                       input_side: bool = False) -> None:
    """Record one tap per statistic type of the channels-last ``x``
    (vitta_tpu/models/layers.py:90-133): 2D features ``(N*T, H, W, C)``
    are unfolded by ``clip_len`` for the time-resolved types; BN1d-style
    low-rank features take the full per-channel reduction."""
    slot = taps.setdefault(name, {})
    for st in stat_types:
        leaf = tap_leaf_name(st, input_side)
        if not _wants(taps, leaf):
            continue
        if st == "spatiotemp":
            slot[leaf] = channel_stats(x)
        elif x.dim() >= 5:
            slot[leaf] = channel_stats(x, stat_type=st, time_axis=1)
        elif x.dim() == 4:
            if clip_len <= 0:
                raise ValueError(f"stat_type={st!r} on a 2D-feature norm "
                                 "layer needs clip_len")
            xr = x.reshape(x.shape[0] // clip_len, clip_len, *x.shape[1:])
            slot[leaf] = channel_stats(xr, stat_type=st, time_axis=1)
        elif st in ("temp", "temp_v2"):
            slot[leaf] = channel_stats(x)
        # 'spatial' on BN1d features has no tap (the reference's None
        # placeholder, basics.py:873-880)
    if not input_side and stat_types and _wants(taps, COUNT_LEAF):
        slot[COUNT_LEAF] = float(x.shape[0] // clip_len
                                 if (x.dim() == 4 and clip_len > 0)
                                 else x.shape[0])


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of a channels-last tensor of any rank.

    torch BatchNorm semantics: eps 1e-5, running-stat momentum 0.1,
    *unbiased* variance for the running update but biased for the
    normalization.  The inference form (``use_running_average=True``,
    ``fix_BNS``) is the default; the batch-stat form optionally updates
    the running statistics in place.  Parameter and buffer names are
    torch's, so a reference state dict loads as it is.
    """

    def __init__(self, features: int, tap_name: str,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 clip_len: int = 0, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        for st in stat_types:
            if st not in STAT_TYPES:
                raise NotImplementedError(f"stat_type={st!r}")
        self.features = features
        self.tap_name = tap_name
        self.stat_types = tuple(stat_types)
        self.clip_len = clip_len
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, taps: Optional[dict] = None, *,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        xf = x.to(torch.float32)
        if taps is not None:
            record_typed_stats(taps, self.tap_name, xf, self.stat_types,
                               self.clip_len, input_side=True)
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.dim() - 1))
            mean = torch.mean(xf, dim=dims)
            var = torch.mean(torch.square(xf), dim=dims) - torch.square(mean)
            if update_running_stats:
                with torch.no_grad():
                    n = xf.numel() / self.features
                    unbiased = var * (n / max(n - 1.0, 1.0))
                    m = self.momentum
                    self.running_mean.copy_((1 - m) * self.running_mean
                                            + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * unbiased)
                    self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        # (x - mean) * inv + bias as one pass over the activation
        y = torch.addcmul(self.bias - mean * inv, xf, inv).to(x.dtype)
        if taps is not None:
            record_typed_stats(taps, self.tap_name, y.to(torch.float32),
                               self.stat_types, self.clip_len)
        return y


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``conv`` to a channels-last ``(N, H, W, C)`` tensor.  The
    permuted view is channels_last memory, which cuDNN and oneDNN take
    and return as is; ``contiguous`` is then free."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def max_pool_nhwc(x, window: int, stride: int, padding: int):
    """torch MaxPool2d (pads with -inf) on ``(N, H, W, C)``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                        padding).permute(0, 2, 3, 1).contiguous()


def global_avg_pool_2d(x):
    """AdaptiveAvgPool2d(1) over (N, H, W, C) -> (N, C)."""
    return torch.mean(x, dim=(1, 2))
