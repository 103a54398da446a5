"""The ViTTA adaptation engine — one adapt+eval step per test video.

The PyTorch counterpart of vitta_tpu/adapt/engine.py (reference
corpus/basics.py:403-747).  One step:

* a tapped forward of the augmented views (``model(views, taps)``), the
  taps restricted to the leaves and layers the step reads;
* per chosen layer: EMA update of the channel statistics
  (``MovingAverageTensor``) or the cumulative meter, and the alignment
  loss against the source statistics — the gradient flows only through
  the current batch's contribution (utils/utils_.py:211).  Under
  ``stat_reg="BNS"`` the source is the model's own running statistics and
  the tap the norm layer's input (BNS_utils.py:19-77); under ``"cossim"``
  the source is a temporal relation-map vector per layer and the tap the
  ``cossim`` one (relation_map_utils.py:186-331);
* sum-L1 prediction consistency across the views
  (pred_consistency_utils.py:15-31);
* ``loss = lambda_reg * sum(reg) + lambda_consis * consis``
  (basics.py:657-667) and one SGD step (``n_gradient_steps`` in
  tta_standard mode);
* an eval forward of the deterministic clip with the *updated* weights
  and no taps (basics.py:691-716).

Where the JAX engine carries an immutable pytree, this engine owns one
live ``nn.Module`` and updates it in place: a ``TTAState`` names the live
parameters, optimizer and EMA, and ``init_state`` resets them.  In
``tta_standard`` mode every step starts from that reset (the reference's
``cp.deepcopy(model_origin)``, basics.py:530).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vitta_tpu_torch.adapt.optim import build_optimizer
from vitta_tpu_torch.config import VittaConfig
from vitta_tpu_torch.models.layers import (COUNT_LEAF, BatchNorm, Taps,
                                           flatten_taps, tap_leaf_name)
from vitta_tpu_torch.models.swin import HalfTwin
from vitta_tpu_torch.ops.losses import (compute_regularization, cross_entropy,
                                        pred_consistency, topk_accuracy)
from vitta_tpu_torch.ops.stats import (CumulativeState, TapStats,
                                       cumulative_update, ema_update)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names the card and
    there is none.  The port's entry points default to ``"cuda"`` and
    never carry on on the CPU by themselves."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for and no CUDA device is "
            "available; pass device=\"cpu\" to run on the CPU")
    return device


class RegSpec(NamedTuple):
    """One statistic-regularization channel: a tap leaf to read, the
    chosen layer names, and their source-side targets (one per configured
    ``stat_type`` in mean_var mode, basics.py:850-906; a single one keyed
    'BNS' / 'cossim' in those modes)."""

    key: str
    leaf: str
    names: Tuple[str, ...]
    source: Dict[str, TapStats]


def batch_stats_as_tapdict(model: torch.nn.Module) -> Dict[str, TapStats]:
    """Copies of the BatchNorm layers' running statistics as
    ``{tap_name: TapStats}``: the source side of the BNS regularization
    (BNFeatureHook captures running_mean / var at init, BNS_utils.py:28-30;
    vitta_tpu/adapt/engine.py:83-97)."""
    return {m.tap_name: TapStats(m.running_mean.detach().clone(),
                                 m.running_var.detach().clone())
            for m in model.modules() if isinstance(m, BatchNorm)}


def select_tap_names(available, chosen_blocks, source_stats=None) -> Tuple[str, ...]:
    """Layer selection by name-substring (corpus/basics.py:571-587) in
    deterministic order, restricted to layers with source statistics."""
    names = []
    for name in sorted(available):
        dotted = name.replace("_", ".")
        if not any((b in name) or (b in dotted) for b in chosen_blocks):
            continue
        if source_stats is not None and name not in source_stats:
            continue
        names.append(name)
    return tuple(names)


@dataclasses.dataclass
class TTAState:
    """The engine's carried state.  ``params`` and ``batch_stats`` are the
    live tensors of the engine's model and ``optimizer`` holds the
    momentum, all updated in place; ``ema`` is replaced each step."""

    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    ema: Dict[str, Any]   # per chosen layer: TapStats (EMA) or CumulativeState
    step: int
    batch_stats: Dict[str, torch.Tensor]


class StepMetrics(NamedTuple):
    loss_reg: torch.Tensor
    loss_consis: torch.Tensor
    loss_ce: torch.Tensor
    top1: torch.Tensor    # 0/100 for a batch of 1
    top5: torch.Tensor
    pred: torch.Tensor    # argmax of eval logits (B,)


class VittaEngine:
    """Owns the model, optimizer and EMA of one adaptation stream.

    ``state_dict`` is the model's weights (a reference checkpoint, or
    ``tanet_state_dict_from_jax`` / ``swin_state_dict_from_jax`` of the
    JAX package's variables); ``source_stats`` is
    ``{tap_name: (mean, var)}``, or ``{stat_type: {tap_name: (mean, var)}}``
    for several types; under ``stat_reg="cossim"`` it is
    ``{tap_name: vector or None}`` (``load_reference_cossim``), and under
    ``"BNS"`` it is not read and may be None.  ``tap_names`` overrides the
    selection by ``chosen_blocks``, restricted to the layers that have a
    source.  Dropout draws from ``self.generator``, a ``torch.Generator``
    on ``device``.

    The engine runs on the card: ``device`` defaults to ``"cuda"`` and the
    constructor raises where there is none.  Only an explicit
    ``device="cpu"`` runs on the CPU, as the tests do.

    A bfloat16 model (``TANet(dtype="bfloat16")``,
    ``Recognizer3D(dtype="bfloat16")``) is taken as it is: its parameters,
    and so the masters that SGD updates, are float32, and the taps,
    losses, EMA and logits it hands back are float32.  TANet casts its
    weights where it uses them.  A bfloat16 Video Swin under SGD reads a
    bfloat16 copy of the weights it casts (``HalfTwin``, vitta_tpu's
    ``params_half``), refreshed after every update and reset, unless
    ``half_twin`` is False: the same values as a cast at every use, with
    two foreach calls a step where the casts took about 600 launches and
    autograd nodes.
    """

    def __init__(self, model: torch.nn.Module, cfg: VittaConfig,
                 state_dict: Dict[str, torch.Tensor],
                 source_stats: Optional[Dict[str, Any]] = None,
                 tap_names: Optional[Tuple[str, ...]] = None, device="cuda",
                 half_twin: bool = True):
        cfg.tta.validate()
        tcfg = cfg.tta
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.generator = torch.Generator(device=self.device)
        # the reset template of init_state and tta_standard
        self.init_params = {k: p.detach().clone()
                            for k, p in self.model.named_parameters()}
        self._init_buffers = {k: b.detach().clone()
                              for k, b in self.model.named_buffers()}
        self._norm_mean = torch.tensor(cfg.data.input_mean, dtype=torch.float32,
                                       device=self.device)
        self._norm_std = torch.tensor(cfg.data.input_std, dtype=torch.float32,
                                      device=self.device)
        self._norm_div255 = cfg.model.arch != "videoswintransformer"

        def pick(src):
            if tap_names is None:
                names = select_tap_names(src.keys(), tcfg.chosen_blocks, src)
            else:  # explicit override, restricted to layers this spec covers
                names = tuple(n for n in tap_names if n in src)
            return names, {k: src[k] for k in names}

        specs = []
        if tcfg.stat_reg == "BNS":
            # always the norm *input*, against the layer's running stats
            specs.append(RegSpec("BNS", "stat_in",
                                 *pick(batch_stats_as_tapdict(self.model))))
        elif tcfg.stat_reg == "cossim":
            if source_stats is None:
                raise ValueError("cossim mode needs relation-map targets "
                                 "(temp_cossim_clean_file)")
            # targets wrapped as zero-variance TapStats: the l1 / mse
            # regularization then coincides with the reference's cossim
            # loss (relation_map_utils.py:326-331); None entries (layers
            # without a relation map) are skipped (basics.py:916)
            src = {}
            for k, v in source_stats.items():
                if v is not None:
                    vec = self._tensor(v)
                    src[k] = TapStats(vec, torch.zeros_like(vec))
            specs.append(RegSpec(
                "cossim", tap_leaf_name("cossim", tcfg.before_norm),
                *pick(src)))
        else:
            if source_stats is None:
                raise ValueError("mean_var mode needs source statistics")
            nested = source_stats and all(isinstance(v, dict)
                                          for v in source_stats.values())
            per_type = (source_stats if nested
                        else {tcfg.stat_type[0]: source_stats})
            for st in tcfg.stat_type:
                if st not in per_type:
                    raise KeyError(f"stat_type {st!r} has no source "
                                   f"statistics (got types {sorted(per_type)})")
                src = {k: TapStats(self._tensor(m), self._tensor(v))
                       for k, (m, v) in per_type[st].items()}
                specs.append(RegSpec(st, tap_leaf_name(st, tcfg.before_norm),
                                     *pick(src)))
        self.reg_specs = tuple(specs)
        self._multi = len(specs) > 1
        self.tap_names = specs[0].names
        leaves = {s.leaf for s in specs}
        if not tcfg.moving_avg:
            leaves.add(COUNT_LEAF)
        self._tap_leaves = frozenset(leaves)
        # the layers any channel reads: no other layer reduces anything
        self._tap_layers = frozenset(n for s in specs for n in s.names)
        self.optimizer = build_optimizer(cfg.optim, self.model,
                                         arch=cfg.model.arch,
                                         partial_bn=cfg.model.partial_bn)
        # the bfloat16 copy of a bfloat16 Swin's cast weights, under SGD
        # (vitta_tpu/adapt/engine.py:262-270)
        HalfTwin.remove(self.model)
        self._twin = (HalfTwin(self.model) if half_twin
                      and cfg.model.arch == "videoswintransformer"
                      and getattr(self.model, "dtype", None) == torch.bfloat16
                      and not cfg.optim.update_only_bn_affine else None)

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def _init_ema_for(self, spec: RegSpec) -> dict:
        if self.cfg.tta.moving_avg or spec.key == "BNS":
            # MovingAverageTensor starts from 0 (utils_.py:204-208)
            return {k: TapStats(torch.zeros_like(s.mean), torch.zeros_like(s.var))
                    for k, s in spec.source.items()}
        # AverageMeterTensor: running sum + count (utils_.py:190-202)
        return {k: CumulativeState(torch.zeros_like(s.mean),
                                   torch.zeros_like(s.var),
                                   torch.zeros((), device=self.device))
                for k, s in spec.source.items()}

    def init_state(self, step: int = 0) -> TTAState:
        """Reset the live model, momentum and EMA to the initial weights;
        return the state that names them."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.init_params[k])
            for k, b in self.model.named_buffers():
                b.copy_(self._init_buffers[k])
        self.model.zero_grad(set_to_none=True)
        self._refresh_twin()
        self.optimizer.state.clear()   # SGD's first step sets v = d, as v0 = 0
        if self._multi:
            ema = {s.key: self._init_ema_for(s) for s in self.reg_specs}
        else:
            ema = self._init_ema_for(self.reg_specs[0])
        return TTAState(dict(self.model.named_parameters()), self.optimizer,
                        ema, step, dict(self.model.named_buffers()))

    def _update(self, loss):
        """Backward and one optimizer step on the masters (through the
        bfloat16 copy's gradients where there is one, refreshed after)."""
        loss.backward()
        if self._twin is not None:
            self._twin.grads_to_masters()
        self.optimizer.step()
        self._refresh_twin()

    def _refresh_twin(self):
        if self._twin is not None:
            self._twin.refresh()

    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _maybe_normalize(self, x):
        """(B, T, H, W, 3) uint8 -> normalized float32 on the device
        (engine.py:372-389); float input passes through."""
        x = self._to_device(x)
        if x.dtype != torch.uint8:
            return x
        xf = x.to(torch.float32)
        if self._norm_div255:
            xf = xf / 255.0
        return (xf - self._norm_mean) / self._norm_std

    def _bn_kw(self) -> dict:
        if self.cfg.tta.fix_BNS:
            # norm layers stay in inference form during adaptation
            # (model.train() + forced BN .eval(), basics.py:606-611)
            return {}
        # fix_BNS=False: batch-stat normalization and running-stat updates
        return dict(use_running_average=False, update_running_stats=True)

    def _losses(self, ema, views, generator):
        tcfg = self.cfg.tta
        taps = Taps(self._tap_leaves, self._tap_layers)
        logits = self.model(views, taps, train=True, generator=generator,
                            **self._bn_kw())
        n_views = tcfg.n_augmented_views if tcfg.if_sample_tta_aug_views else 1
        bv = logits.shape[0]
        counts = flatten_taps(taps, COUNT_LEAF)
        loss_reg = torch.zeros((), device=self.device)
        new_ema = {}
        for spec in self.reg_specs:
            tapd = flatten_taps(taps, spec.leaf)
            ema_sub = ema[spec.key] if self._multi else ema
            new_sub = {}
            for name in spec.names:
                if spec.key == "BNS":
                    # BNFeatureHook: raw batch stats, or running-manner EMA
                    # with momentum_bns (BNS_utils.py:55-77)
                    updated = (ema_update(ema_sub[name], tapd[name],
                                          tcfg.momentum_bns)
                               if tcfg.running_manner else tapd[name])
                    new_sub[name] = updated
                elif tcfg.moving_avg:
                    updated = ema_update(ema_sub[name], tapd[name],
                                         tcfg.momentum_mvg)
                    new_sub[name] = updated
                else:
                    new_sub[name], updated = cumulative_update(
                        ema_sub[name], tapd[name], counts.get(name, float(bv)))
                loss_reg = loss_reg + compute_regularization(
                    spec.source[name], updated, tcfg.reg_type)
            new_ema[spec.key] = new_sub
        if not self._multi:
            new_ema = new_ema[self.reg_specs[0].key]
        view_logits = logits.reshape(bv // n_views, n_views, -1)
        if tcfg.if_sample_tta_aug_views and tcfg.if_pred_consistency:
            loss_consis = pred_consistency(view_logits)
            loss = (tcfg.lambda_feature_reg * loss_reg
                    + tcfg.lambda_pred_consis * loss_consis)
        else:
            loss_consis = torch.zeros((), device=self.device)
            loss = loss_reg
        return loss, loss_reg, loss_consis, view_logits.mean(dim=1), new_ema

    def eval_logits(self, eval_clip, params=None):
        """Deterministic forward without taps; clips/crops folded in the
        batch axis are averaged (basics.py:695-708)."""
        eval_clip = self._maybe_normalize(eval_clip)
        with torch.no_grad():
            if params is None:
                logits = self.model(eval_clip, None, train=False)
            else:
                logits = torch.func.functional_call(
                    self.model, {**dict(self.model.named_buffers()), **params},
                    (eval_clip, None), {"train": False})
        # vitta_tpu/adapt/engine.py:528-531
        n_eval_views = self.cfg.data.test_crops * (
            int(self.cfg.data.sample_style.split("-")[-1])
            if self.cfg.model.arch == "tanet" else self.cfg.data.num_clips)
        b = logits.shape[0] // n_eval_views
        return logits.reshape(b, n_eval_views, -1).mean(dim=1)

    # ------------------------------------------------------------------
    def adapt_eval_step(self, state: TTAState, views, eval_clip, label,
                        generator: Optional[torch.Generator] = None):
        """One test video: adapt on its augmented views, then evaluate its
        eval clip.  ``views`` (V, T, H, W, 3) and ``eval_clip``
        (E, T, H, W, 3) are uint8 or float, ``label`` (B,) ints.  Returns
        ``(state, StepMetrics)``; the metrics stay on the device."""
        if self.cfg.tta.if_tta_standard == "tta_standard":
            state = self.init_state(state.step)
        generator = self.generator if generator is None else generator
        views = self._maybe_normalize(views)
        label = self._to_device(label).long()
        ema = state.ema
        for _ in range(self.cfg.tta.n_gradient_steps):
            # the model's, not the optimizer's: partial-BN's frozen
            # parameters get gradients too
            self.model.zero_grad(set_to_none=True)
            loss, loss_reg, loss_consis, mean_logits, ema = self._losses(
                ema, views, generator)
            self._update(loss)
        # detach the EMA carry (the meter's sum is detached between steps)
        ema = _detach(ema)
        loss_ce = cross_entropy(mean_logits.detach(), label)
        eval_logits = self.eval_logits(eval_clip)
        top1, top5 = topk_accuracy(eval_logits, label)
        metrics = StepMetrics(loss_reg.detach(), loss_consis.detach(), loss_ce,
                              top1, top5, torch.argmax(eval_logits, -1))
        return dataclasses.replace(state, ema=ema, step=state.step + 1), metrics

    def adapt_step(self, state: TTAState, views, label,
                   generator: Optional[torch.Generator] = None):
        """Adaptation without the per-video evaluation: one gradient step
        on ``views``, for the epoch-style loop that adapts over the whole
        stream and evaluates once at the end (``test_time_adapt``,
        basics.py:760-1084; vitta_tpu/adapt/engine.py:545-563).  Returns
        ``(state, (loss_reg, loss_consis, loss_ce))``."""
        generator = self.generator if generator is None else generator
        views = self._maybe_normalize(views)
        label = self._to_device(label).long()
        self.model.zero_grad(set_to_none=True)
        loss, loss_reg, loss_consis, mean_logits, ema = self._losses(
            state.ema, views, generator)
        self._update(loss)
        loss_ce = cross_entropy(mean_logits.detach(), label)
        state = dataclasses.replace(state, ema=_detach(ema),
                                    step=state.step + 1)
        return state, (loss_reg.detach(), loss_consis.detach(), loss_ce)

    def eval_step(self, params, eval_clip, label):
        """(top1, top5, pred) of ``eval_clip`` under ``params``
        ({name: tensor}, e.g. ``init_params``), leaving the live model as
        it is."""
        logits = self.eval_logits(eval_clip, params)
        top1, top5 = topk_accuracy(logits, self._to_device(label).long())
        return top1, top5, torch.argmax(logits, -1)


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, tuple):
        return type(tree)(*(_detach(v) for v in tree))
    return {k: _detach(v) for k, v in tree.items()}
