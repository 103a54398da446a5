"""Temporal Adaptive Module (TAM).

The PyTorch counterpart of vitta_tpu/models/tam.py (reference
models/tanet_models/temporal_module.py:12-65):

* global branch ``G``: Linear(T->2T, no bias) + BN1d + ReLU +
  Linear(2T->K, no bias) + softmax, a per-(sample, channel) dynamic
  temporal kernel of size K (=3);
* local branch ``L``: Conv1d(C->C/4, k3, pad1, no bias) + BN1d + ReLU +
  Conv1d(C/4->C, k1, no bias) + sigmoid, a temporal attention over (C,T);
* the dynamic depthwise temporal convolution, ``tam_dynamic_conv``: the
  hand-written CUDA kernel on the card, its plain version on the CPU.

The branches run in float32 whatever x's dtype, on a float32 pooling of x
(vitta_tpu/models/tam.py:52-72); the dynamic convolution takes x at its
dtype (bfloat16 in the bfloat16 TANet) beside float32 attn and kernel.

Submodule names are the reference's (``G.0``, ``G.1``, ``L.0`` ...), so
its state dict loads as it is; the BN1d taps carry the JAX names
``<block>.tam.g_bn`` and ``<block>.tam.l_bn``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vitta_tpu_torch.models.layers import BatchNorm
from vitta_tpu_torch.ops.cuda_tam import tam_dynamic_conv


class TAM(nn.Module):
    def __init__(self, in_channels: int, clip_len: int, tap_prefix: str,
                 kernel_size: int = 3,
                 stat_types: Tuple[str, ...] = ("spatiotemp",)):
        super().__init__()
        t, c = clip_len, in_channels
        self.clip_len = clip_len
        self.kernel_size = kernel_size
        self.G = nn.Sequential(
            nn.Linear(t, 2 * t, bias=False),
            BatchNorm(2 * t, f"{tap_prefix}.g_bn", stat_types),
            nn.ReLU(),
            nn.Linear(2 * t, kernel_size, bias=False),
            nn.Softmax(dim=-1))
        self.L = nn.Sequential(
            nn.Conv1d(c, c // 4, kernel_size, padding=kernel_size // 2,
                      bias=False),
            BatchNorm(c // 4, f"{tap_prefix}.l_bn", stat_types),
            nn.ReLU(),
            nn.Conv1d(c // 4, c, 1, bias=False),
            nn.Sigmoid())

    def forward(self, x, taps: Optional[dict] = None, **bn_kw):
        """x (N*T, H, W, C) channels-last -> (N*T, H, W, C)."""
        nt, h, w, c = x.shape
        t = self.clip_len
        n = nt // t

        # spatial pool: (N*T, H, W, C) -> (N, T, C), summed in float32
        # without a float32 copy of x
        pooled = torch.mean(x, dim=(1, 2), dtype=torch.float32).reshape(
            n, t, c)

        # global branch: Dense over T for each (sample, channel)
        g = self.G[0](pooled.transpose(1, 2).reshape(n * c, t))
        g = self.G[2](self.G[1](g, taps, **bn_kw))
        kernel = self.G[4](self.G[3](g)).reshape(n, c, self.kernel_size)

        # local branch: Conv1d on (N, C, T); its BN is channels-last (N, T, C/4)
        # (laid out anew: the norm layers take contiguous activations, and
        # this one is N*T*C/4 values)
        l = self.L[0](pooled.transpose(1, 2)).transpose(1, 2).contiguous()
        l = self.L[2](self.L[1](l, taps, **bn_kw))
        attn = self.L[4](self.L[3](l.transpose(1, 2))).transpose(1, 2)

        out = tam_dynamic_conv(x.reshape(n, t, h, w, c), attn.contiguous(),
                               kernel.contiguous())
        return out.reshape(nt, h, w, c)
