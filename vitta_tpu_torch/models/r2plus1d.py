"""R(2+1)D-18.

The PyTorch counterpart of vitta_tpu/models/r2plus1d.py (reference
models/r2plus1d.py: torchvision ``r2plus1d_18`` with a fresh classifier):
every 3D conv factored into a spatial (1, 3, 3) conv, BatchNorm, ReLU and a
temporal (3, 1, 1) conv, with torchvision's midplanes

    mid = (kt * kh * kw * cin * cout) // (kh * kw * cin + kt * cout)

Channels-last clips ``(B, T, H, W, C)``; the convs run on
``channels_last_3d`` views (``conv_ndhwc``), every BatchNorm records its
statistics into the tap dict.  Module and tap names are the JAX package's
(``layer3_0.conv1.bn_mid``, ``stem_bn``, ``clsfr``): vitta_tpu builds the
model from random weights only, so there is no reference checkpoint layout
to follow.  Float32 only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vitta_tpu_torch.models.layers import BatchNorm, conv_ndhwc

R2PLUS1D_LAYERS = ((64, 2), (128, 2), (256, 2), (512, 2))


def _midplanes(cin: int, cout: int, kt=3, kh=3, kw=3) -> int:
    return (kt * kh * kw * cin * cout) // (kh * kw * cin + kt * cout)


def _conv(cin, cout, kernel, stride=(1, 1, 1), padding=(0, 0, 0)):
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


class Conv2Plus1D(nn.Module):
    """Spatial (1, 3, 3) conv -> BN -> ReLU -> temporal (3, 1, 1) conv
    (vitta_tpu/models/r2plus1d.py:26-43)."""

    def __init__(self, cin: int, features: int, tap_prefix: str,
                 stride=(1, 1, 1)):
        super().__init__()
        mid = _midplanes(cin, features)
        st, sh, sw = stride
        self.spatial = _conv(cin, mid, (1, 3, 3), (1, sh, sw), (0, 1, 1))
        self.bn_mid = BatchNorm(mid, f"{tap_prefix}.bn_mid")
        self.temporal = _conv(mid, features, (3, 1, 1), (st, 1, 1),
                              (1, 0, 0))

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        x = torch.relu(self.bn_mid(conv_ndhwc(self.spatial, x), taps,
                                   **bn_kw))
        return conv_ndhwc(self.temporal, x)


class BasicBlock2Plus1D(nn.Module):
    """(vitta_tpu/models/r2plus1d.py:46-64)"""

    def __init__(self, inplanes: int, planes: int, tap_prefix: str,
                 stride=(1, 1, 1), downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2Plus1D(inplanes, planes, f"{tap_prefix}.conv1",
                                 stride)
        self.bn1 = BatchNorm(planes, f"{tap_prefix}.bn1")
        self.conv2 = Conv2Plus1D(planes, planes, f"{tap_prefix}.conv2")
        self.bn2 = BatchNorm(planes, f"{tap_prefix}.bn2")
        self.downsample_conv = self.downsample_bn = None
        if downsample:
            self.downsample_conv = _conv(inplanes, planes, (1, 1, 1), stride)
            self.downsample_bn = BatchNorm(planes,
                                           f"{tap_prefix}.downsample_bn")

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        out = torch.relu(self.bn1(self.conv1(x, taps, **bn_kw), taps,
                                  **bn_kw))
        out = self.bn2(self.conv2(out, taps, **bn_kw), taps, **bn_kw)
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(conv_ndhwc(self.downsample_conv, x),
                                          taps, **bn_kw)
        return torch.relu(out + identity)


class R2Plus1D(nn.Module):
    """R(2+1)D-18: (B, T, H, W, 3) -> (B, K)."""

    def __init__(self, num_classes: int):
        super().__init__()
        # torchvision's stem: 45 midplanes, (1, 7, 7) / (1, 2, 2), then
        # (3, 1, 1) temporal
        self.stem_spatial = _conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
        self.stem_bn_mid = BatchNorm(45, "stem_bn_mid")
        self.stem_temporal = _conv(45, 64, (3, 1, 1), padding=(1, 0, 0))
        self.stem_bn = BatchNorm(64, "stem_bn")
        self.block_names = []
        inplanes = 64
        for li, (planes, blocks) in enumerate(R2PLUS1D_LAYERS, start=1):
            for bi in range(blocks):
                first = li > 1 and bi == 0
                name = f"layer{li}_{bi}"
                setattr(self, name, BasicBlock2Plus1D(
                    inplanes, planes, name,
                    stride=(2, 2, 2) if first else (1, 1, 1),
                    downsample=first))
                self.block_names.append(name)
                inplanes = planes
        self.clsfr = nn.Linear(512, num_classes)
        nn.init.normal_(self.clsfr.weight, std=0.01)
        nn.init.zeros_(self.clsfr.bias)

    def forward(self, x, taps: Optional[dict] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        bn_kw = dict(use_running_average=use_running_average,
                     update_running_stats=update_running_stats)
        x = torch.relu(self.stem_bn_mid(conv_ndhwc(self.stem_spatial, x),
                                        taps, **bn_kw))
        x = torch.relu(self.stem_bn(conv_ndhwc(self.stem_temporal, x), taps,
                                    **bn_kw))
        for name in self.block_names:
            x = getattr(self, name)(x, taps, **bn_kw)
        return self.clsfr(torch.mean(x, dim=(1, 2, 3)))
