"""Loss functions for test-time adaptation.

The PyTorch counterpart of vitta_tpu/ops/losses.py:

* ``compute_regularization`` (reference utils/norm_stats_utils.py:531-542):
  mean-reduced L1/MSE of variance + of mean, or a KL divergence between
  Gaussians (``compute_kld``, norm_stats_utils.py:8-16).
* ``pred_consistency`` (reference utils/pred_consistency_utils.py:15-31):
  softmax each view, mean over views (NOT detached), then **sum-reduced**
  L1 between each view's softmax and the mean, averaged over views.
* ``softmax_entropy`` (reference baselines/tent.py:29-32).
"""

from __future__ import annotations

import torch

from vitta_tpu_torch.ops.stats import TapStats


def gaussian_kld(mean_true, mean_pred, var_true, var_pred) -> torch.Tensor:
    """Sum-reduced KL(N(true) || N(pred)) (norm_stats_utils.py:8-16)."""
    kld = (0.5 * torch.log(var_pred / var_true)
           + (var_true + torch.square(mean_true - mean_pred)) / (2.0 * var_pred)
           - 0.5)
    return torch.sum(kld)


def compute_regularization(source: TapStats, estimate: TapStats,
                           reg_type: str = "l1_loss") -> torch.Tensor:
    """``loss(var) + loss(mean)`` with mean reduction for l1/mse
    (norm_stats_utils.py:537-542)."""
    if reg_type == "l1_loss":
        return (torch.mean(torch.abs(source.var - estimate.var))
                + torch.mean(torch.abs(source.mean - estimate.mean)))
    if reg_type == "mse_loss":
        return (torch.mean(torch.square(source.var - estimate.var))
                + torch.mean(torch.square(source.mean - estimate.mean)))
    if reg_type == "kld":
        return gaussian_kld(source.mean, estimate.mean, source.var, estimate.var)
    raise NotImplementedError(f"reg_type={reg_type}")


def pred_consistency(view_logits: torch.Tensor) -> torch.Tensor:
    """Prediction-consistency loss over augmented views; ``view_logits``
    is (batch, n_views, n_class) pre-softmax."""
    softmaxs = torch.softmax(view_logits, dim=-1)               # (B, V, K)
    avg = torch.mean(softmaxs, dim=1, keepdim=True)             # (B, 1, K)
    per_view = torch.sum(torch.abs(softmaxs - avg), dim=(0, 2))  # (V,)
    return torch.mean(per_view)


def softmax_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Per-sample entropy of softmax(logits) (baselines/tent.py:29-32)."""
    log_p = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(log_p) * log_p, dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with integer labels (torch CrossEntropyLoss)."""
    log_p = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(log_p, -1, labels[:, None].long()))


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Top-k precision in percent (reference utils/utils_.py:224-237)."""
    maxk = min(max(ks), logits.shape[-1])
    pred = torch.topk(logits, maxk, dim=-1).indices             # (B, maxk)
    correct = pred == labels[:, None]
    return tuple(100.0 * torch.mean(
        torch.sum(correct[:, :min(k, maxk)], dim=1).to(torch.float32))
        for k in ks)
