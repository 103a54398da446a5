"""Relation-map / pairwise-similarity statistics.

The PyTorch counterpart of vitta_tpu/ops/relation.py (reference
utils/relation_map_utils.py):

* ``upper_triangle_idx`` / ``upper_triangle_cosine`` (:18-43): cosine
  similarity of all unordered element pairs, in the reference's order;
* ``exp_norm_relation_map`` (:11-16): row-normalized exponential map;
* the per-stat-type rearrangements of ``ComputePairwiseSimilarityHook``
  (:116-185): 'temp' -> (N, T, CHW), 'spatiotemp' -> (N, THW, C),
  'channel' -> (N, C, THW), 'spatial' -> PCA-reduced (1, T, HW);
* the cossim regularization of ``CombineCossimRegHook`` (:186-331).

Used by the ``stat_reg='cossim'`` mode (the ``cossim`` tap of
models/layers.py) and by ``compute_cossim_statistics``.

The cosine is taken from the E x E Gram matrix of the rows and the rows'
norms, gathered at the pair indices.  The JAX package gathers the two
(N, pairs, D) operands and multiplies them; at TANet's layer3, where
D = C*H*W = 200,704 and T = 16 gives 120 pairs, those copies are 190 MB per
layer and view, against a 16 x 16 matrix here.  The two forms add the same
products in another order: they agree to float32 rounding of a sum over D
terms (the tests hold them to rtol 1e-4 / atol 1e-6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def upper_triangle_idx(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Index pairs (i, j), i < j, in the reference's enumeration order
    (relation_map_utils.py:18-28)."""
    i1, i2 = [], []
    for v in range(n - 1):
        i1 += [v] * (n - 1 - v)
    for s in range(1, n):
        i2 += list(range(s, n))
    return np.asarray(i1, np.int64), np.asarray(i2, np.int64)


def upper_triangle_cosine(feature: torch.Tensor) -> torch.Tensor:
    """feature (N, E, D) -> (N, E*(E-1)/2) pairwise cosine similarities,
    ``num / max(|a| |b|, 1e-8)``."""
    e = feature.shape[1]
    i1, i2 = (torch.from_numpy(i).to(feature.device)
              for i in upper_triangle_idx(e))
    gram = torch.matmul(feature, feature.transpose(1, 2))      # (N, E, E)
    norm = torch.linalg.vector_norm(feature, dim=-1)           # (N, E)
    num = gram[:, i1, i2]
    den = norm[:, i1] * norm[:, i2]
    return num / torch.clamp(den, min=1e-8)


def exp_norm_relation_map(sym: torch.Tensor) -> torch.Tensor:
    """(N, E, E) -> row-sum-normalized exp map (relation_map_utils.py:11-16)."""
    ex = torch.exp(sym)
    return ex / torch.sum(ex, dim=2, keepdim=True)


def _rearrange_ncthw(x: torch.Tensor, stat_type: str) -> torch.Tensor:
    """x is channels-last (N, T, H, W, C) -> (N, E, D) per stat type."""
    n, t, h, w, c = x.shape
    if stat_type == "temp":
        return x.permute(0, 1, 4, 2, 3).reshape(n, t, c * h * w)
    if stat_type == "spatiotemp":
        return x.reshape(n, t * h * w, c)
    if stat_type == "channel":
        return x.permute(0, 4, 1, 2, 3).reshape(n, c, t * h * w)
    if stat_type == "spatial":
        # PCA-reduce the (HW, NCT) columns to T (relation_map_utils.py:
        # 170-175; torch.pca_lowrank there): center + truncated SVD.  The
        # sign of each component is free.
        flat = x.permute(0, 4, 1, 2, 3).reshape(n * c * t, h * w).T
        centered = flat - torch.mean(flat, dim=0, keepdim=True)
        u, s, _ = torch.linalg.svd(centered, full_matrices=False)
        red = (u[:, :t] * s[:t]).T
        return red.reshape(1, *red.shape)
    raise NotImplementedError(stat_type)


def pairwise_similarity(x: torch.Tensor, stat_type: str = "temp") -> torch.Tensor:
    """Batch-mean upper-triangle cosine similarity vector of a
    channels-last feature tensor (ComputePairwiseSimilarityHook)."""
    feat = _rearrange_ncthw(x, stat_type)
    return torch.mean(upper_triangle_cosine(feat), dim=0)


def relation_map(x: torch.Tensor, stat_type: str = "temp") -> torch.Tensor:
    """Batch-mean exp-normalized relation map (ComputeRelationMapHook)."""
    feat = _rearrange_ncthw(x, stat_type)
    sym = torch.matmul(feat, feat.transpose(1, 2))
    return torch.mean(exp_norm_relation_map(sym), dim=0)


def cossim_regularization(sim_true: torch.Tensor, sim_pred: torch.Tensor,
                          reg_type: str = "l1_loss") -> torch.Tensor:
    if reg_type == "l1_loss":
        return torch.mean(torch.abs(sim_pred - sim_true))
    if reg_type == "mse_loss":
        return torch.mean(torch.square(sim_pred - sim_true))
    raise NotImplementedError(reg_type)
