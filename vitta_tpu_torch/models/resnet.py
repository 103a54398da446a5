"""ResNet-50 backbone with a TAM in every bottleneck (TANet).

The PyTorch counterpart of vitta_tpu/models/resnet.py (reference
models/tanet_models/tanet.py:125-150 and temporal_module.py:68-140):

* channels-last frames ``(N*T, H, W, C)``;
* stride on the 3x3 conv2 (torchvision v1.5 Bottleneck);
* TAM inserted after conv1/bn1/relu (temporal_module.py:85-91), or no
  TAM where ``use_tam`` is False (a plain ResNet-50 of frames,
  vitta_tpu/models/resnet.py:37,53,86);
* every BatchNorm records its channel statistics into the tap dict;
* ``dtype`` is the compute dtype: the stem casts the normalised input to
  it (vitta_tpu/models/resnet.py:95), convolutions, BatchNorm outputs,
  residual adds and ReLUs run at it, the TAM's branches and the pooled
  features are float32, the parameters always float32.

Module names are the reference checkpoint's (``layer3.2.net.conv1``,
``layer3.2.tam.G.0``), so its state dict loads with ``strict=True``; tap
names are the JAX package's (``base_model.layer3_2.bn1``), so one
source-statistics dict serves both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from vitta_tpu_torch.models.layers import (BatchNorm, conv_nhwc,
                                           global_avg_pool_2d, max_pool_nhwc)
from vitta_tpu_torch.models.tam import TAM

# the compute dtypes the model runs at, by the names of the configuration
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``dtype`` ("float32", "bfloat16" or a torch dtype) as a torch dtype;
    raises on any other."""
    name = str(dtype).replace("torch.", "")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype!r}: the port's models run "
                         f"at {' or '.join(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


RESNET50_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    # (planes, blocks, first-stride)
    (64, 3, 1),
    (128, 4, 2),
    (256, 6, 2),
    (512, 3, 2),
)


class BottleneckNet(nn.Module):
    """The convs and norms of a torchvision Bottleneck (the reference's
    ``.net``); ``Bottleneck`` runs them around the TAM."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool, tap_prefix: str, clip_len: int,
                 stat_types: Tuple[str, ...]):
        super().__init__()
        out_planes = planes * 4
        bn = lambda c, name: BatchNorm(c, f"{tap_prefix}.{name}", stat_types,
                                       clip_len)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = bn(planes, "bn1")
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = bn(planes, "bn2")
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = bn(out_planes, "bn3")
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out_planes, 1, stride=stride, bias=False),
                bn(out_planes, "downsample_bn"))


class Bottleneck(nn.Module):
    """torchvision Bottleneck + TAM (none where ``use_tam`` is False),
    expansion 4."""

    def __init__(self, inplanes: int, planes: int, clip_len: int,
                 tap_prefix: str, stride: int = 1, downsample: bool = False,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 use_tam: bool = True):
        super().__init__()
        self.net = BottleneckNet(inplanes, planes, stride, downsample,
                                 tap_prefix, clip_len, stat_types)
        self.tam = (TAM(planes, clip_len, f"{tap_prefix}.tam",
                        stat_types=stat_types) if use_tam else None)

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        net = self.net
        out = torch.relu(net.bn1(conv_nhwc(net.conv1, x), taps, **bn_kw))
        if self.tam is not None:
            out = self.tam(out, taps, **bn_kw)
        out = torch.relu(net.bn2(conv_nhwc(net.conv2, out), taps, **bn_kw))
        out = net.bn3(conv_nhwc(net.conv3, out), taps, **bn_kw)
        identity = x
        if net.downsample is not None:
            identity = net.downsample[1](conv_nhwc(net.downsample[0], x),
                                         taps, **bn_kw)
        return torch.relu(out + identity)


class ResNetTAM(nn.Module):
    """ResNet-50 (+ TAM where ``use_tam``) feature extractor: (N*T, H, W,
    3) -> (N*T, 2048) float32, computing at ``dtype`` (float32 or
    bfloat16)."""

    def __init__(self, clip_len: int,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 tap_prefix: str = "base_model",
                 dtype: Union[str, torch.dtype] = torch.float32,
                 use_tam: bool = True):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, f"{tap_prefix}.bn1", stat_types, clip_len)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(RESNET50_LAYERS,
                                                      start=1):
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(
                    inplanes, planes, clip_len, f"{tap_prefix}.layer{li}_{bi}",
                    stride=stride if bi == 0 else 1, downsample=(bi == 0),
                    stat_types=stat_types, use_tam=use_tam))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*stage))

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        x = x.to(self.dtype)
        x = torch.relu(self.bn1(conv_nhwc(self.conv1, x), taps, **bn_kw))
        x = max_pool_nhwc(x, 3, 2, 1)
        for li in range(1, len(RESNET50_LAYERS) + 1):
            for block in getattr(self, f"layer{li}"):
                x = block(x, taps, **bn_kw)
        return global_avg_pool_2d(x)
