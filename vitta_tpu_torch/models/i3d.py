"""I3D: a 3D-ResNet backbone and the I3D head.

The PyTorch counterpart of vitta_tpu/models/i3d.py (reference models/i3d.py
and models/backbones/resnet3d.py):

* a (5, 7, 7) / 2 stem and a (1, 3, 3) max-pool of stride (2, 2, 2)
  (resnet3d.py:190-198);
* BasicBlock3d (3x3x3 pairs; depths 18, 34) and Bottleneck3d (1x1x1,
  3x3x3, 1x1x1; depths 50, 101, 152), spatial-only downsampling stride
  (1, s, s) (resnet3d.py:19-31);
* the head: global average pool, Dropout(0.5) drawn from the caller's
  ``torch.Generator``, Linear (i3d.py:28-61);
* ``inflate_conv2d_to_3d``: 2D -> 3D weights by temporal replication over
  kt (resnet3d.py:276-307).

Channels-last clips ``(B, T, H, W, C)``; the convs run on
``channels_last_3d`` views (``conv_ndhwc``); every BatchNorm records its
statistics.  Module and tap names are the JAX package's
(``backbone.layer3_0.bn1``, ``fc_cls``).  Float32 only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vitta_tpu_torch.models.layers import (BatchNorm, conv_ndhwc,
                                           max_pool_ndhwc)
from vitta_tpu_torch.models.tanet import dropout as _dropout

I3D_DEPTHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv3d(cin, cout, kernel, stride=(1, 1, 1)):
    """A conv padded by (k - 1) // 2 on each side (i3d.py:_conv3d)."""
    pad = tuple((k - 1) // 2 for k in kernel)
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=pad,
                     bias=False)


class BasicBlock3d(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, tap_prefix: str,
                 stride: int = 1, downsample: bool = False):
        super().__init__()
        s = (1, stride, stride)
        self.conv1 = _conv3d(inplanes, planes, (3, 3, 3), s)
        self.bn1 = BatchNorm(planes, f"{tap_prefix}.bn1")
        self.conv2 = _conv3d(planes, planes, (3, 3, 3))
        self.bn2 = BatchNorm(planes, f"{tap_prefix}.bn2")
        self.downsample_conv = self.downsample_bn = None
        if downsample:
            self.downsample_conv = _conv3d(inplanes, planes, (1, 1, 1), s)
            self.downsample_bn = BatchNorm(planes,
                                           f"{tap_prefix}.downsample_bn")

    def _identity(self, x, taps, bn_kw):
        if self.downsample_conv is None:
            return x
        return self.downsample_bn(conv_ndhwc(self.downsample_conv, x), taps,
                                  **bn_kw)

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        out = torch.relu(self.bn1(conv_ndhwc(self.conv1, x), taps, **bn_kw))
        out = self.bn2(conv_ndhwc(self.conv2, out), taps, **bn_kw)
        return torch.relu(out + self._identity(x, taps, bn_kw))


class Bottleneck3d(BasicBlock3d):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, tap_prefix: str,
                 stride: int = 1, downsample: bool = False):
        nn.Module.__init__(self)
        s = (1, stride, stride)
        out_planes = planes * 4
        self.conv1 = _conv3d(inplanes, planes, (1, 1, 1))
        self.bn1 = BatchNorm(planes, f"{tap_prefix}.bn1")
        self.conv2 = _conv3d(planes, planes, (3, 3, 3), s)
        self.bn2 = BatchNorm(planes, f"{tap_prefix}.bn2")
        self.conv3 = _conv3d(planes, out_planes, (1, 1, 1))
        self.bn3 = BatchNorm(out_planes, f"{tap_prefix}.bn3")
        self.downsample_conv = self.downsample_bn = None
        if downsample:
            self.downsample_conv = _conv3d(inplanes, out_planes, (1, 1, 1), s)
            self.downsample_bn = BatchNorm(out_planes,
                                           f"{tap_prefix}.downsample_bn")

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        out = torch.relu(self.bn1(conv_ndhwc(self.conv1, x), taps, **bn_kw))
        out = torch.relu(self.bn2(conv_ndhwc(self.conv2, out), taps, **bn_kw))
        out = self.bn3(conv_ndhwc(self.conv3, out), taps, **bn_kw)
        return torch.relu(out + self._identity(x, taps, bn_kw))


class ResNet3d(nn.Module):
    """(B, T, H, W, 3) -> (B, T', H', W', F) feature maps."""

    def __init__(self, depth: int = 50, tap_prefix: str = "backbone"):
        super().__init__()
        kind, layers = I3D_DEPTHS[depth]
        block = BasicBlock3d if kind == "basic" else Bottleneck3d
        self.conv1 = nn.Conv3d(3, 64, (5, 7, 7), stride=(2, 2, 2),
                               padding=(2, 3, 3), bias=False)
        self.bn1 = BatchNorm(64, f"{tap_prefix}.bn1")
        self.block_names = []
        inplanes = 64
        for li, blocks in enumerate(layers, start=1):
            planes = 64 * 2 ** (li - 1)
            for bi in range(blocks):
                stride = 2 if (li > 1 and bi == 0) else 1
                name = f"layer{li}_{bi}"
                setattr(self, name, block(
                    inplanes, planes, f"{tap_prefix}.{name}", stride=stride,
                    downsample=(stride != 1
                                or inplanes != planes * block.expansion)))
                self.block_names.append(name)
                inplanes = planes * block.expansion
        self.num_features = inplanes

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        x = torch.relu(self.bn1(conv_ndhwc(self.conv1, x), taps, **bn_kw))
        x = max_pool_ndhwc(x, (1, 3, 3), (2, 2, 2), (0, 1, 1))
        for name in self.block_names:
            x = getattr(self, name)(x, taps, **bn_kw)
        return x


class I3D(nn.Module):
    """Backbone and head (reference i3d.py:7-25): (B, T, H, W, 3) ->
    (B, K)."""

    def __init__(self, num_classes: int, depth: int = 50,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.backbone = ResNet3d(depth)
        self.fc_cls = nn.Linear(self.backbone.num_features, num_classes)

    def _pooled(self, x, taps, bn_kw):
        return torch.mean(self.backbone(x, taps, **bn_kw), dim=(1, 2, 3))

    def features(self, x, *, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 use_running_average: bool = True,
                 update_running_stats: bool = False):
        """The pooled backbone features (B, F), without the dropout
        (vitta_tpu/models/i3d.py:141-145)."""
        return self._pooled(x, None, dict(
            use_running_average=use_running_average,
            update_running_stats=update_running_stats))

    def classify(self, feats):
        return self.fc_cls(feats)

    def forward(self, x, taps: Optional[dict] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        pooled = self._pooled(x, taps, dict(
            use_running_average=use_running_average,
            update_running_stats=update_running_stats))
        if train and self.dropout > 0:
            pooled = _dropout(pooled, self.dropout, generator)
        return self.fc_cls(pooled)


# the name the model-zoo dispatch uses (vitta_tpu/models/i3d.py:153)
I3DResNet = I3D


def inflate_conv2d_to_3d(w2d: np.ndarray, kt: int) -> np.ndarray:
    """A 2D kernel (kh, kw, cin, cout) -> 3D (kt, kh, kw, cin, cout) by
    temporal replication over kt (vitta_tpu/models/i3d.py:157-161)."""
    w = np.repeat(w2d[None], kt, axis=0) / float(kt)
    return w.astype(w2d.dtype)
