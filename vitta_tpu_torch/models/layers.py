"""BatchNorm and LayerNorm with statistic taps, and channels-last conv
helpers.

The PyTorch counterpart of vitta_tpu/models/layers.py:136-258.  The
reference registers forward hooks on its norm modules
(utils/norm_stats_utils.py, corpus/basics.py:565-600); here a tapped
forward fills a dict that the caller passes down, ``model(x, taps={})``,
and ``taps=None`` reduces nothing — the "hooks removed" eval path.

The dict maps each norm layer's name — exactly the JAX package's
flattened tap name, e.g. ``base_model.layer3_0.bn1`` — to its leaves:
``stat`` (output side), ``stat_in`` (input side), ``stat_<type>`` for the
other statistic types, and the count leaf ``stat_n``.  A plain dict
collects every leaf of every layer; a ``Taps`` collects only its
``leaves``, and only at its ``names`` where those are given, so the
adaptation step pays for no reduction it does not read (in the JAX package
XLA removes the reductions nobody reads).

In the inference form a tapped ``BatchNorm`` takes its output and the
output-side ``stat`` leaf from one op, ``fused_bn_relu_stats``
(ops/cuda_stats.py): on the card one pass over the activation instead of
the normalization and two reductions.

Types: activations are float32, or bfloat16 in the bfloat16 TANet
(``TANet(dtype="bfloat16")``); parameters, statistics and taps are always
float32.  A norm layer computes in float32 and returns its input's dtype;
its taps read a float32 view of the activation, made only where a leaf is
recorded.  ``conv_nhwc`` runs a conv at its input's dtype from the float32
master weights, as flax's ``promote_dtype`` does.

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

from vitta_tpu_torch.ops.cuda_ln import layer_norm
from vitta_tpu_torch.ops.cuda_stats import fused_bn_relu_stats
from vitta_tpu_torch.ops.relation import (pairwise_similarity,
                                          upper_triangle_cosine)
from vitta_tpu_torch.ops.stats import TapStats, channel_stats

# Leaf carrying the reference's per-layer batch count ``bz`` — the ``n``
# of the cumulative meters (norm_stats_utils.py:177-182,244-249).
COUNT_LEAF = "stat_n"

STAT_TYPES = ("spatiotemp", "spatial", "temp", "temp_v2", "cossim")


def tap_leaf_name(stat_type: str, input_side: bool = False) -> str:
    """Leaf name of a statistic type (vitta_tpu/models/layers.py:51)."""
    base = "stat_in" if input_side else "stat"
    return base if stat_type == "spatiotemp" else f"{base}_{stat_type}"


class Taps(dict):
    """A tap dict that collects only the named ``leaves``, and only at the
    layers in ``names`` (None: every layer; the counterpart of ``tap_names``
    at vitta_tpu/adapt/engine.py:172)."""

    def __init__(self, leaves: Iterable[str],
                 names: Optional[Iterable[str]] = None):
        super().__init__()
        self.leaves = frozenset(leaves)
        self.names = None if names is None else frozenset(names)


def _wants(taps: dict, leaf: str, name: Optional[str] = None) -> bool:
    """Whether ``taps`` collects ``leaf`` (at the layer ``name``)."""
    names = getattr(taps, "names", None)
    if name is not None and names is not None and name not in names:
        return False
    leaves = getattr(taps, "leaves", None)
    return leaves is None or leaf in leaves


def flatten_taps(taps: dict, leaf: str = "stat") -> dict:
    """{name: value} of one leaf (vitta_tpu/adapt/engine.py:66)."""
    return {name: leaves[leaf] for name, leaves in taps.items()
            if leaf in leaves}


def _cossim_vector(x: torch.Tensor, clip_len: int):
    """The temporal pairwise-similarity vector of a norm layer's feature
    (vitta_tpu/models/layers.py:62-87, CombineCossimRegHook.hook_fn,
    relation_map_utils.py:254-299): rank 5 and rank 4 unfolded by
    ``clip_len`` give the (T, T) upper triangle over CHW rows, rank-3 BN1d
    features the one over their T rows of C; rank 2 has no relation map
    (None)."""
    if x.dim() == 5:
        return pairwise_similarity(x, "temp")
    if x.dim() == 4 and clip_len > 0:
        xr = x.reshape(x.shape[0] // clip_len, clip_len, *x.shape[1:])
        return pairwise_similarity(xr, "temp")
    if x.dim() == 3:                     # (N, T, C) channels-last BN1d
        return torch.mean(upper_triangle_cosine(x), dim=0)
    return None


def record_typed_stats(taps: dict, name: str, x: torch.Tensor,
                       stat_types: Tuple[str, ...], clip_len: int,
                       input_side: bool = False,
                       count: Optional[float] = None,
                       spatiotemp: Optional[TapStats] = None) -> None:
    """Record one tap per statistic type of the channels-last ``x``
    (vitta_tpu/models/layers.py:90-133): 2D features ``(N*T, H, W, C)``
    are unfolded by ``clip_len`` for the time-resolved types; BN1d-style
    low-rank features take the full per-channel reduction; ``cossim`` is
    the similarity vector wrapped as a zero-variance ``TapStats``, so that
    the meters and the l1 / mse regularization apply unchanged.  ``count``
    overrides the count leaf where dim 0 of ``x`` is not the reference
    batch; ``spatiotemp`` is that type's statistics of ``x`` where the
    caller has them already.  A layer that ``taps`` does not name records
    nothing.  The statistics are of ``x`` in float32: a bfloat16 ``x`` is
    read as float32 once, and only where a leaf is reduced from it."""
    names = getattr(taps, "names", None)
    if names is not None and name not in names:
        return
    slot = taps.setdefault(name, {})
    wanted = [st for st in stat_types
              if _wants(taps, tap_leaf_name(st, input_side))]
    if any(st != "spatiotemp" or spatiotemp is None for st in wanted):
        x = x.to(torch.float32)
    for st in wanted:
        leaf = tap_leaf_name(st, input_side)
        if st == "cossim":
            sim = _cossim_vector(x, clip_len)
            if sim is not None:
                slot[leaf] = TapStats(sim, torch.zeros_like(sim))
        elif st == "spatiotemp":
            slot[leaf] = channel_stats(x) if spatiotemp is None else spatiotemp
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
        if count is None:
            count = (x.shape[0] // clip_len if (x.dim() == 4 and clip_len > 0)
                     else x.shape[0])
        slot[COUNT_LEAF] = float(count)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of a channels-last tensor of any rank.

    torch BatchNorm semantics: eps 1e-5, running-stat momentum 0.1,
    *unbiased* variance for the running update but biased for the
    normalization.  The inference form (``use_running_average=True``,
    ``fix_BNS``) is the default; the batch-stat form optionally updates
    the running statistics in place.  Parameter and buffer names are
    torch's, so a reference state dict loads as it is.

    Where a tapped forward in the inference form reads this layer's
    output-side ``stat`` leaf, y and the leaf come from
    ``fused_bn_relu_stats(..., relu=False)``: exactly ``y = BN(x)`` followed
    by ``channel_stats(y)`` (vitta_tpu/models/layers.py:183-190).  The other
    statistic types are reduced from y by the plain functions; the
    batch-statistics form (its mean and var carry gradients) and the
    untapped forward stay plain tensor code.

    The math is float32 and y has x's dtype: a bfloat16 x gives a bfloat16
    y (rounded once), whose statistics are those of the rounded y, as in
    vitta_tpu.  The kernel reads and writes bfloat16, and so does the
    inference form where no kernel runs (torch's ``batch_norm`` at
    bfloat16 with float32 parameters); a float32 copy of x is made only for
    the batch-statistics form and where an input-side leaf is recorded.
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
        if taps is not None:
            record_typed_stats(taps, self.tap_name, x, self.stat_types,
                               self.clip_len, input_side=True)
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.to(torch.float32)
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
        if (use_running_average and taps is not None
                and "spatiotemp" in self.stat_types
                and _wants(taps, "stat", self.tap_name)):
            # the inference form with its output's statistics read: y and
            # the "stat" leaf from one op (the kernel on the card)
            y, stat = fused_bn_relu_stats(
                x, self.weight, self.bias, mean, var, eps=self.eps,
                relu=False)
            record_typed_stats(taps, self.tap_name, y, self.stat_types,
                               self.clip_len, spatiotemp=stat)
            return y
        if use_running_average and x.dtype != torch.float32:
            # bfloat16 in the inference form: one pass that reads and
            # writes bfloat16 and computes in float32 (torch's batch_norm
            # with float32 parameters), y rounded once
            y = F.batch_norm(x.movedim(-1, 1), mean, var, self.weight,
                             self.bias, False, 0.0,
                             self.eps).movedim(1, -1).contiguous()
        else:
            inv = torch.rsqrt(var + self.eps) * self.weight
            # (x - mean) * inv + bias as one float32 pass over the
            # activation, rounded to x's dtype
            y = torch.addcmul(self.bias - mean * inv, x, inv).to(x.dtype)
        if taps is not None:
            record_typed_stats(taps, self.tap_name, y, self.stat_types,
                               self.clip_len)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with statistic taps on both sides
    (vitta_tpu/models/layers.py:194-258).

    The Swin tap points are all LayerNorms except the patch-embed one
    (corpus/basics.py:500-505), whose ``tap`` is False.  The variance is
    the one-pass ``E[x^2] - E[x]^2`` in float32.  Parameter names are
    torch's (``weight``, ``bias``).  Modes of ``forward``:

    * ``"full"``: normalize ``x`` and return y, taps on both sides;
    * ``"params"``: record the input-side tap of ``x`` and return
      ``(weight, bias)`` for a fused consumer (ops/cuda_mlp.py normalizes
      inside its kernel);
    * ``"sow_output"``: ``x`` is the y computed elsewhere; record the
      output-side tap under this layer's name and return it.

    ``stat_count`` overrides the tap's count leaf when dim 0 of ``x`` is
    not the reference batch.
    """

    def __init__(self, features: int, tap_name: str, eps: float = 1e-5,
                 tap: bool = True,
                 stat_types: Tuple[str, ...] = ("spatiotemp",)):
        super().__init__()
        for st in stat_types:
            if st not in STAT_TYPES:
                raise NotImplementedError(f"stat_type={st!r}")
        self.features = features
        self.tap_name = tap_name
        self.eps = eps
        self.tap = tap
        self.stat_types = tuple(stat_types)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, taps: Optional[dict] = None, mode: str = "full",
                stat_count: Optional[int] = None):
        tapped = self.tap and taps is not None
        if mode == "sow_output":
            if tapped:
                record_typed_stats(taps, self.tap_name, x.to(torch.float32),
                                   self.stat_types, 0, count=stat_count)
            return x
        if tapped:
            record_typed_stats(taps, self.tap_name, x.to(torch.float32),
                               self.stat_types, 0, input_side=True)
        if mode == "params":
            return self.weight, self.bias
        if mode != "full":
            raise ValueError(f"unknown LayerNorm mode {mode!r}")
        y = layer_norm(x, self.weight, self.bias, self.eps)
        if tapped:
            record_typed_stats(taps, self.tap_name, y.to(torch.float32),
                               self.stat_types, 0, count=stat_count)
        return y


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``conv`` to a channels-last ``(N, H, W, C)`` tensor at x's
    dtype: the float32 weight is cast to it, as flax's ``promote_dtype``
    does (vitta_tpu/models/resnet.py), and its gradient comes back to the
    float32 master through the cast.  The permuted view is channels_last
    memory, which cuDNN and oneDNN take and return as is; ``contiguous`` is
    then free."""
    weight = conv.weight.to(x.dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_ndhwc(conv: nn.Conv3d, x: torch.Tensor,
               padding=None) -> torch.Tensor:
    """Apply ``conv`` to a channels-last clip ``(N, T, H, W, C)``, with
    ``padding`` in place of the module's where given.  The permuted view is
    ``channels_last_3d`` memory, which cuDNN takes and returns as is, so
    the view back is contiguous and ``contiguous`` is free: no copy of the
    activation is made.  Float32, as every model that calls it."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias,
                 conv.stride, conv.padding if padding is None else padding,
                 conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def max_pool_ndhwc(x, window, stride, padding=0):
    """torch MaxPool3d (pads with -inf) on ``(N, T, H, W, C)``."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, stride,
                        padding).permute(0, 2, 3, 4, 1).contiguous()


def max_pool_nhwc(x, window: int, stride: int, padding: int):
    """torch MaxPool2d (pads with -inf) on ``(N, H, W, C)``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                        padding).permute(0, 2, 3, 1).contiguous()


def global_avg_pool_2d(x):
    """AdaptiveAvgPool2d(1) over (N, H, W, C) -> (N, C) float32, whatever
    x's dtype (vitta_tpu/models/resnet.py upcasts before it pools); the sum
    is float32, with no float32 copy of x."""
    return torch.mean(x, dim=(1, 2), dtype=torch.float32)
