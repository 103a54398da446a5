"""Source-statistic precompute — a map over the clean training set.

The PyTorch counterpart of vitta_tpu/adapt/precompute.py (reference
``compute_statistics``, corpus/basics.py:220-309): run the clean training
list through the model with statistic taps, accumulate per-layer channel
mean/variance weighted by batch size (``AverageMeter.update(value,
n=batch)``, basics.py:298-300 — the reference averages per-batch *biased
variances*, not the variance of the pooled set; replicated here), and save
both the reference-compatible object-array ``.npy`` pair
(basics.py:306-307) and a name-keyed ``.npz``.

``compute_cossim_statistics`` is the relation-map precompute of the cossim
mode (``compute_cos_similarity``, basics.py:311-401).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vitta_tpu_torch.adapt.engine import resolve_device
from vitta_tpu_torch.models.layers import (BatchNorm, LayerNorm, Taps,
                                           flatten_taps, tap_leaf_name)
from vitta_tpu_torch.ops.relation import (pairwise_similarity,
                                          upper_triangle_cosine)
from vitta_tpu_torch.ops.stats import TapStats
from vitta_tpu_torch.utils.checkpoint import save_stats


class StatAccumulator:
    """AverageMeter over tap dicts (reference utils_.py:171-187), summed
    in float64 on the host."""

    def __init__(self):
        self.sum_mean: Dict[str, np.ndarray] = {}
        self.sum_var: Dict[str, np.ndarray] = {}
        self.count = 0.0

    def update(self, taps: Dict[str, TapStats], n: float):
        for name, s in taps.items():
            m = s.mean.detach().cpu().numpy().astype(np.float64)
            v = s.var.detach().cpu().numpy().astype(np.float64)
            if name not in self.sum_mean:
                self.sum_mean[name] = m * n
                self.sum_var[name] = v * n
            else:
                self.sum_mean[name] += m * n
                self.sum_var[name] += v * n
        self.count += n

    def result(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        return {name: ((self.sum_mean[name] / self.count).astype(np.float32),
                       (self.sum_var[name] / self.count).astype(np.float32))
                for name in self.sum_mean}


def compute_source_statistics(model: torch.nn.Module, data_iter,
                              device="cuda", tap_filter=None, logger=None,
                              print_freq: int = 50,
                              stat_type: str = "spatiotemp"):
    """``data_iter`` yields (clips (B, T, S, S, 3) float32, labels); the
    model holds its weights already.

    Returns {tap_name: (mean, var)} with per-``stat_type`` shapes
    (ComputeNormStatsHook, norm_stats_utils.py:80-98): (C,) spatiotemp /
    temp_v2, (C, T) spatial, (C, H, W) temp.  The model must have been
    built with ``stat_type`` in its ``stat_types`` so the taps exist.
    Runs without gradients on ``device``, by default the card: it raises
    where there is none, and only ``device="cpu"`` runs on the CPU.
    """
    device = resolve_device(device)
    model = model.to(device)
    leaf = tap_leaf_name(stat_type)
    acc = StatAccumulator()
    for bi, (clips, _labels) in enumerate(data_iter):
        x = torch.as_tensor(clips).to(device)
        taps = Taps({leaf})
        with torch.no_grad():
            model(x, taps, train=False)
        stats = flatten_taps(taps, leaf)
        if tap_filter is not None:
            stats = {k: s for k, s in stats.items() if tap_filter(k)}
        acc.update(stats, n=float(x.shape[0]))
        if logger and bi % print_freq == 0:
            logger.debug(f"compute_stats batch {bi}")
    return acc.result()


def _batch_similarity(feat: torch.Tensor, clip_len: int, stat_type: str):
    """One norm layer's batch-mean similarity vector, or None where the
    feature has no relation map (vitta_tpu/adapt/precompute.py:122-140)."""
    if feat.dim() == 4:              # (N*T, H, W, C) -> (N, T, H, W, C)
        feat = feat.reshape(feat.shape[0] // clip_len, clip_len,
                            *feat.shape[1:])
    elif feat.dim() == 3:
        # rank-3 BN1d feature, channels-last (N, T, C): the temporal map
        # over its T rows (compute_sim_for_NCT, relation_map_utils.py:
        # 153-162), for 'temp' only; other types have a None placeholder
        # at BN1d positions (basics.py:333-335)
        if stat_type != "temp":
            return None
        return torch.mean(upper_triangle_cosine(feat), dim=0)
    elif feat.dim() != 5:
        return None                  # rank-2 BN1d features: no relation map
    return pairwise_similarity(feat, stat_type)


def compute_cossim_statistics(model: torch.nn.Module, data_iter,
                              clip_len: int, stat_type: str = "temp",
                              device="cuda", tap_filter=None, logger=None):
    """Pairwise-similarity precompute, the counterpart of
    ``compute_cos_similarity`` (corpus/basics.py:311-401) with
    ``ComputePairwiseSimilarityHook``: per norm layer, the batch-mean
    upper-triangle cosine-similarity vector of its output, averaged over
    the batches with AverageMeter weighting.  Returns
    ``{tap_name: vector}``; ``save_cossim`` writes it as
    ``list_{stat_type}_relationmap``.

    Where flax captures the norm modules' outputs, forward hooks on the
    port's ``BatchNorm`` and ``LayerNorm`` modules read them (a LayerNorm
    whose normalization runs inside a fused op hands its y to the module in
    ``"sow_output"`` mode, which the hook sees like any output).  The
    ``"ln_proj"`` attention route returns that y in window layout, which
    has lost the time axis: build the model on another route.  So does a
    stage built window-resident (``VITTA_WINDOW_RESIDENT`` with the
    spatiotemp taps alone): build the model with the cossim taps, as a
    cossim run does, or with the flag off.  Runs without gradients on
    ``device``, by default the card.
    """
    device = resolve_device(device)
    model = model.to(device)
    if any(getattr(m, "attn_route", None) == "ln_proj"
           for m in model.modules()):
        raise ValueError("the relation-map precompute needs the norm "
                         "outputs in token layout: build the model with an "
                         "attn_route other than 'ln_proj'")
    if any(getattr(m, "window_resident", False) for m in model.modules()):
        raise ValueError("the relation-map precompute needs the norm "
                         "outputs in token layout: build the model with "
                         "stat_types=('cossim',) or VITTA_WINDOW_RESIDENT "
                         "off")
    sims: Dict[str, TapStats] = {}

    def hook(module, _args, out):
        # reduced here, so that no layer's activation outlives its forward;
        # the "params" mode's (weight, bias) pair is no activation
        if not isinstance(out, torch.Tensor):
            return
        name = module.tap_name
        if tap_filter is not None and not tap_filter(name):
            return
        sim = _batch_similarity(out.to(torch.float32), clip_len, stat_type)
        if sim is not None:
            sims[name] = TapStats(sim, torch.zeros_like(sim))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (BatchNorm, LayerNorm))]
    acc = StatAccumulator()
    try:
        for bi, (clips, _labels) in enumerate(data_iter):
            x = torch.as_tensor(clips).to(device)
            sims.clear()
            with torch.no_grad():
                model(x, None, train=False)
            acc.update(sims, n=float(x.shape[0]))
            if logger and bi % 50 == 0:
                logger.debug(f"compute_cossim batch {bi}")
    finally:
        for h in handles:
            h.remove()
    return {k: m for k, (m, _v) in acc.result().items()}


def save_source_statistics(stats, arch: str, out_dir: str,
                           use_tam: bool = True, tag: Optional[str] = None,
                           stat_type: str = "spatiotemp",
                           depths=(2, 2, 18, 2)):
    """Write the reference-format ``list_{stat_type}_{mean,var}_{tag}.npy``
    pair (basics.py:306-307) plus a name-keyed npz; returns the three
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    tag = tag or time.strftime("%Y%m%d_%H%M%S")
    mean_path = os.path.join(out_dir, f"list_{stat_type}_mean_{tag}.npy")
    var_path = os.path.join(out_dir, f"list_{stat_type}_var_{tag}.npy")
    save_stats(mean_path, var_path, stats, arch, use_tam=use_tam,
               include_bn1d=(arch == "tanet"
                             and stat_type in ("temp", "temp_v2")),
               depths=depths)
    npz_path = os.path.join(out_dir, f"{stat_type}_stats_{tag}.npz")
    flat = {}
    for name, (m, v) in stats.items():
        flat[f"mean/{name}"] = m
        flat[f"var/{name}"] = v
    np.savez(npz_path, **flat)
    return mean_path, var_path, npz_path


def load_source_statistics_npz(path: str):
    """The name-keyed npz of ``save_source_statistics`` as
    ``{tap_name: (mean, var)}``."""
    out: Dict[str, list] = {}
    with np.load(path) as data:
        for key in data.files:
            kind, name = key.split("/", 1)
            out.setdefault(name, [None, None])[0 if kind == "mean" else 1] = \
                data[key]
    return {k: (m, v) for k, (m, v) in out.items()}
