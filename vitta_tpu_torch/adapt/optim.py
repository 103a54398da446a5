"""Optimizer for the adaptation step.

The PyTorch counterpart of vitta_tpu/adapt/optim.py (reference
corpus/basics.py:547-560): SGD over all parameters, lr 5e-5, momentum
0.9, weight decay 5e-4, in torch's order (d = g + wd*p; v = mu*v + d;
p -= lr*v).  ``torch.optim.SGD`` computes exactly that update; the JAX
package hand-fused it (``fused_sgd_step``, optim.py:98) only to save XLA
dispatches.

Partial-BN (TSN.train(), tanet.py:182-198): with ``partial_bn`` the
weight/bias of every BatchNorm2d except the stem's ``base_model.bn1`` stay
frozen — here by leaving them out of the optimizer, where the JAX package
multiplies their update by a 0 mask (optim.py:34).  TAM's BN1d affine
stays trainable (torch's partial-BN matches BatchNorm2d only).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from vitta_tpu_torch.config import OptimConfig

# BatchNorm2d affine of the bottlenecks: net.bn1/2/3 and net.downsample.1
_BN2D_AFFINE = re.compile(r"\.net\.(bn[123]|downsample\.1)\.(weight|bias)$")


def tanet_trainable_mask(named_params) -> Dict[str, bool]:
    """True = trainable.  Freezes BatchNorm2d weight/bias except the stem
    ``base_model.bn1`` (the first BN2d, tanet.py:189-198)."""
    return {name: not _BN2D_AFFINE.search(name) for name, _ in named_params}


def build_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                    arch: str = "tanet",
                    partial_bn: bool = False) -> torch.optim.Optimizer:
    """torch-style SGD(momentum, weight_decay) over the trainable
    parameters of ``model``."""
    if cfg.update_only_bn_affine:
        raise NotImplementedError(
            "update_only_bn_affine (Adam on norm affine) is not ported yet")
    named = list(model.named_parameters())
    if arch == "tanet" and partial_bn:
        mask = tanet_trainable_mask(named)
        params = [p for name, p in named if mask[name]]
    else:
        params = [p for _, p in named]
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay)
