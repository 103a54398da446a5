"""I3D Inception-v1 (DeepMind's I3D).

The PyTorch counterpart of vitta_tpu/models/i3d_incep.py (reference
models/i3d_incep.py: Unit3D :48, InceptionModule :124, InceptionI3d :152):
TensorFlow's SAME padding for every conv and max-pool, which puts the odd
element of the padding after the input (asymmetric at stride 2); BatchNorm
eps 1e-3, momentum 0.01 in torch's convention after every conv, no conv
bias; a global average pool, Dropout(0.5) drawn from the caller's
``torch.Generator`` and the 1x1x1 logits conv as a Linear.

The max-pools pad with -inf, as flax's ``nn.max_pool`` does: symmetric
padding is ``F.max_pool3d``'s own (which pads with -inf), an asymmetric one
is an explicit ``F.pad`` with -inf first.  An asymmetric conv padding is an
explicit zero ``F.pad``.  Channels-last clips ``(B, T, H, W, C)``; module
and tap names are the JAX package's (``Mixed_4b.b1b.bn``).  Float32 only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from vitta_tpu_torch.models.layers import (BatchNorm, conv_ndhwc,
                                           max_pool_ndhwc)
from vitta_tpu_torch.models.tanet import dropout as _dropout

# out channels per branch of each Inception block, the reference's order:
# b0_1x1, b1_1x1, b1_3x3, b2_1x1, b2_3x3, b3_1x1
INCEPTION_CFG = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def same_padding(sizes, kernel, stride):
    """TensorFlow's SAME padding per axis: (before, after) with the odd
    element after, so that the output is ceil(size / stride)."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _flat_pad(pads):
    """(before, after) per (T, H, W) -> F.pad's argument on (N, T, H, W,
    C)."""
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (0, 0, w0, w1, h0, h1, t0, t1)


def max_pool_same(x, window, stride):
    """flax ``nn.max_pool(..., padding="SAME")`` on (N, T, H, W, C)."""
    pads = same_padding(x.shape[1:4], window, stride)
    if all(a == b for a, b in pads):
        return max_pool_ndhwc(x, window, stride, tuple(a for a, _ in pads))
    x = F.pad(x, _flat_pad(pads), value=float("-inf"))
    return max_pool_ndhwc(x, window, stride)


class Unit3D(nn.Module):
    """SAME conv, BatchNorm(eps 1e-3, momentum 0.01), ReLU
    (vitta_tpu/models/i3d_incep.py:37-55)."""

    def __init__(self, cin: int, features: int, tap_prefix: str,
                 kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        self.conv3d = nn.Conv3d(cin, features, kernel, stride=stride,
                                bias=False)
        self.bn = BatchNorm(features, f"{tap_prefix}.bn", eps=1e-3,
                            momentum=0.01)

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        conv = self.conv3d
        pads = same_padding(x.shape[1:4], conv.kernel_size, conv.stride)
        if all(a == b for a, b in pads):
            y = conv_ndhwc(conv, x, tuple(a for a, _ in pads))
        else:
            y = conv_ndhwc(conv, F.pad(x, _flat_pad(pads)), 0)
        return torch.relu(self.bn(y, taps, **bn_kw))


class InceptionModule(nn.Module):
    """(vitta_tpu/models/i3d_incep.py:58-72)"""

    def __init__(self, cin: int, cfg, tap_prefix: str):
        super().__init__()
        c0, c1a, c1b, c2a, c2b, c3 = cfg
        unit = lambda ci, co, name, k=(1, 1, 1): Unit3D(
            ci, co, f"{tap_prefix}.{name}", k)
        self.b0 = unit(cin, c0, "b0")
        self.b1a = unit(cin, c1a, "b1a")
        self.b1b = unit(c1a, c1b, "b1b", (3, 3, 3))
        self.b2a = unit(cin, c2a, "b2a")
        self.b2b = unit(c2a, c2b, "b2b", (3, 3, 3))
        self.b3b = unit(cin, c3, "b3b")
        self.features = c0 + c1b + c2b + c3

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        b0 = self.b0(x, taps, **bn_kw)
        b1 = self.b1b(self.b1a(x, taps, **bn_kw), taps, **bn_kw)
        b2 = self.b2b(self.b2a(x, taps, **bn_kw), taps, **bn_kw)
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)), taps, **bn_kw)
        return torch.cat([b0, b1, b2, b3], dim=-1)


class InceptionI3d(nn.Module):
    """(B, T, H, W, 3) -> (B, K)."""

    def __init__(self, num_classes: int, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.Conv3d_1a_7x7 = Unit3D(3, 64, "Conv3d_1a_7x7", (7, 7, 7),
                                    (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64, "Conv3d_2b_1x1")
        self.Conv3d_2c_3x3 = Unit3D(64, 192, "Conv3d_2c_3x3", (3, 3, 3))
        cin = 192
        for name, cfg in INCEPTION_CFG.items():
            module = InceptionModule(cin, cfg, name)
            setattr(self, name, module)
            cin = module.features
        self.logits = nn.Linear(cin, num_classes)

    def forward(self, x, taps: Optional[dict] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        kw = dict(use_running_average=use_running_average,
                  update_running_stats=update_running_stats)
        x = self.Conv3d_1a_7x7(x, taps, **kw)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2b_1x1(x, taps, **kw)
        x = self.Conv3d_2c_3x3(x, taps, **kw)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3b(x, taps, **kw)
        x = self.Mixed_3c(x, taps, **kw)
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x, taps, **kw)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5b(x, taps, **kw)
        x = self.Mixed_5c(x, taps, **kw)
        x = torch.mean(x, dim=(1, 2, 3))
        if train and self.dropout > 0:
            x = _dropout(x, self.dropout, generator)
        return self.logits(x)
