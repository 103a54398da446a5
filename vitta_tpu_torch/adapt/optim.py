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

``update_only_bn_affine`` (utils/BNS_utils.py:262-288): Adam(lr, betas
(adam_b1, adam_b2), no weight decay) over the weight and bias of the norm
layers alone, every other parameter frozen, partial-BN not applied
(vitta_tpu/adapt/optim.py:125-129).  ``torch.optim.Adam`` and ``optax.adam``
compute the same update: both add eps (1e-8) outside the square root of the
bias-corrected second moment.

``VITTA_BF16_MOMENTUM`` (vitta_tpu/adapt/optim.py:87-95, read at
vitta_tpu/adapt/engine.py:329-330): SGD's momentum buffers in bfloat16
(``HalfMomentumSGD``), the parameters float32 masters.  Off by default, as
there.
"""

from __future__ import annotations

import os
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


# weight and bias of the norm layers the JAX package's ``norm_affine_mask``
# names (vitta_tpu/adapt/optim.py:51-62: bn1/2/3, downsample_bn, g_bn, l_bn,
# norm, norm1, norm2), under the port's state-dict names (the model zoo's
# CNNs keep ``downsample_bn``).  The patch embedding's norm is
# ``patch_embed_norm`` there and so not in the set.
_NORM_AFFINE = re.compile(
    r"(^|\.)(bn[123]|downsample\.1|downsample_bn|G\.1|L\.1|norm|norm1|"
    r"norm2)\.(weight|bias)$")


def norm_affine_mask(named_params) -> Dict[str, bool]:
    """True for the weight / bias of norm layers (collect_bn_params,
    BNS_utils.py:278-288)."""
    return {name: bool(_NORM_AFFINE.search(name))
            and ".patch_embed.norm." not in name
            for name, _ in named_params}


def half_momentum_enabled() -> bool:
    """Carry SGD's momentum buffers in bfloat16: ``VITTA_BF16_MOMENTUM``
    set to anything non-empty, as vitta_tpu reads it
    (vitta_tpu/adapt/optim.py:87-95).  Default off."""
    return bool(os.environ.get("VITTA_BF16_MOMENTUM"))


class HalfMomentumSGD(torch.optim.Optimizer):
    """SGD(momentum, weight_decay) with bfloat16 momentum buffers over
    float32 parameters, vitta_tpu's ``fused_sgd_step`` on a bfloat16
    momentum tree (vitta_tpu/adapt/optim.py:98-122), in its order:
    ``v2 = mu * float(v) + g + wd * p``, ``p -= lr * v2``, ``v =
    bfloat16(v2)``, the arithmetic float32.  A buffer starts at 0, so the
    first step is vitta_tpu's to the bit (and within a float32 ulp of
    ``torch.optim.SGD``'s, which adds ``-lr * v`` in one rounding); after
    it the buffers' bfloat16 rounding is what differs."""

    def __init__(self, params, lr: float, momentum: float,
                 weight_decay: float):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("HalfMomentumSGD takes no closure")
        for group in self.param_groups:
            lr, mu, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                v = state.get("momentum_buffer")
                if v is None:
                    v = torch.zeros_like(p, dtype=torch.bfloat16)
                v2 = mu * v.float() + p.grad.float() + wd * p
                p.sub_(lr * v2)
                state["momentum_buffer"] = v2.to(torch.bfloat16)


def build_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                    arch: str = "tanet",
                    partial_bn: bool = False) -> torch.optim.Optimizer:
    """torch-style SGD(momentum, weight_decay) over the trainable
    parameters of ``model`` (``HalfMomentumSGD`` where
    ``half_momentum_enabled()``), or with ``update_only_bn_affine`` Adam
    over its norm layers' weight and bias."""
    named = list(model.named_parameters())
    if cfg.update_only_bn_affine:
        mask = norm_affine_mask(named)
        return torch.optim.Adam([p for name, p in named if mask[name]],
                                lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2))
    if arch == "tanet" and partial_bn:
        mask = tanet_trainable_mask(named)
        params = [p for name, p in named if mask[name]]
    else:
        params = [p for _, p in named]
    sgd = HalfMomentumSGD if half_momentum_enabled() else torch.optim.SGD
    return sgd(params, lr=cfg.lr, momentum=cfg.momentum,
               weight_decay=cfg.weight_decay)
