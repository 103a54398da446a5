"""The bfloat16 Video Swin (``Recognizer3D(dtype="bfloat16")``, packed
route, the engine's bfloat16 twin of the cast weights) under the engine's
other modes that vitta_tpu runs on Video Swin, against the JAX
``VittaEngine`` on ``Recognizer3D(dtype="bfloat16")`` with its
``params_half`` twin: 3-step trajectories under ``stat_reg="cossim"`` and
``tta_epoch_adapt`` (3 mean_var adapt-only steps, then one ``validate``
pass).  BNS reads BatchNorm layers, of which Video Swin has none.

The model, weights, videos and lr are tests/test_torch_bf16_swin_engine
.py's (every width a multiple of 128, as Swin-B's); the tolerances are
tests/test_torch_bf16_engine.py's, as in tests/test_torch_bf16_modes.py:
reg and ce losses rtol 1e-3, consistency atol 2e-4, predictions and
top-1 exactly; the EMA's mean within 1e-2 of its largest magnitude, its
variance at rtol 2e-2 / atol 1e-2 of the largest v + m^2; the whole
update within 5% of its norm, the median tensor's within 2%, every
tensor's within 75%, every tensor JAX moves moved.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_bf16_swin_engine as bse
from tests.test_torch_bf16_modes import (EACH, MEDIAN, WHOLE, assert_ema,
                                         assert_losses)
from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.adapt.loops import tta_epoch_adapt as jax_tta_epoch_adapt
from vitta_tpu.config import swin_ucf101_preset as jax_preset
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.adapt.loops import tta_epoch_adapt
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.utils.checkpoint import swin_state_dict_from_jax

torch.set_num_threads(1)

COSSIM = dict(stat_reg="cossim", stat_type=("temp",))


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(bse.K, bse.PATCH, bse.EMBED, bse.DEPTHS,
                               bse.HEADS, bse.WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, bse.K, depths=bse.DEPTHS,
                                        window_size=bse.WINDOW)
    return sd, variables


def _source(variables, stat_types, leaf):
    """One float32 tapped JAX forward of a seeded clean clip."""
    clean = np.random.default_rng(100).normal(
        size=(bse.V, bse.T, bse.HW, bse.HW, 3)).astype(np.float32)
    _, aux = JaxRecognizer3D(drop_path_rate=0.0, stat_types=stat_types,
                             **bse.MODEL_KW).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    return jax_flatten_taps(aux["taps"], leaf)


def _engines(weights, src, **tta):
    sd, variables = weights
    stat_types = ("cossim",) if tta.get("stat_reg") == "cossim" \
        else ("spatiotemp",)
    jcfg, cfg = bse._cfg(jax_preset), bse._cfg(swin_ucf101_preset)
    jcfg = jcfg.replace(tta=dataclasses.replace(jcfg.tta, **tta))
    cfg = cfg.replace(tta=dataclasses.replace(cfg.tta, **tta))
    kw = dict(drop_path_rate=0.0, head_dropout=0.0, dtype="bfloat16",
              stat_types=stat_types, **bse.MODEL_KW)
    jeng = JaxEngine(JaxRecognizer3D(**kw), jcfg, variables, src,
                     donate=False)
    eng = VittaEngine(Recognizer3D(**kw), cfg, sd, src, device="cpu")
    assert jeng._half and eng._twin is not None
    assert eng.tap_names == tuple(jeng.tap_names) and eng.tap_names
    return jeng, eng


def _assert_updates(eng, jstate, sd):
    want = swin_state_dict_from_jax({"params": jstate.params},
                                    depths=bse.DEPTHS, window_size=bse.WINDOW)
    diffs, norms, each = [], [], []
    for k, p in eng.model.named_parameters():
        init = sd[k].numpy().astype(np.float64)
        dj, dp = want[k].numpy() - init, p.detach().numpy() - init
        diff, norm = np.linalg.norm(dp - dj), np.linalg.norm(dj)
        diffs.append(diff)
        norms.append(norm)
        if norm > 0:
            assert np.linalg.norm(dp) > 0, f"{k}: JAX moves it, the port not"
            assert diff <= EACH * norm, f"{k}: {diff / norm:.3f} of its norm"
            each.append(diff / norm)
        else:
            assert diff == 0, k
    whole = np.linalg.norm(diffs) / np.linalg.norm(norms)
    assert whole <= WHOLE, f"the whole update: {whole:.4f} of its norm"
    assert np.median(each) <= MEDIAN, np.median(each)


def _cossim_runs(weights):
    src = {n: np.asarray(s.mean) for n, s in _source(
        weights[1], ("cossim",), "stat_cossim").items()}
    jeng, eng = _engines(weights, src, **COSSIM)
    assert eng.reg_specs[0].leaf == "stat_cossim"
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    losses, preds = [], []
    for i, (views, clip, label) in enumerate(bse._videos()):
        jstate, jm = jeng.adapt_eval_step(
            jstate, jnp.asarray(views), jnp.asarray(clip), jnp.asarray(label),
            jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        losses.append(((m.loss_reg, m.loss_consis, m.loss_ce),
                       (jm.loss_reg, jm.loss_consis, jm.loss_ce)))
        preds.append(([float(m.top1), float(m.top5), m.pred.tolist()],
                      [float(jm.top1), float(jm.top5),
                       np.asarray(jm.pred).tolist()]))
    return dict(eng=eng, state=state, jstate=jstate, losses=losses,
                preds=preds)


def _epoch_runs(weights):
    """The adapt-only steps one by one (their losses), then
    tta_epoch_adapt: one epoch and the evaluation pass."""
    src = {n: (np.asarray(s.mean), np.asarray(s.var)) for n, s in _source(
        weights[1], ("spatiotemp",), "stat").items()}
    jeng, eng = _engines(weights, src)
    data = bse._videos()
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    losses = []
    for i, (views, _clip, label) in enumerate(data):
        jstate, jl = jeng.adapt_step(jstate, jnp.asarray(views),
                                     jnp.asarray(label),
                                     jax.random.fold_in(rng, i))
        state, pl = eng.adapt_step(state, views, label)
        losses.append((pl, jl))
    eval_data = [(clip, label) for _views, clip, label in data]
    jtop1, jstate = jax_tta_epoch_adapt(
        jeng, [tuple(jnp.asarray(a) for a in item) for item in data],
        [(jnp.asarray(c), np.asarray(lb)) for c, lb in eval_data],
        n_epochs=1)
    top1, state = tta_epoch_adapt(eng, data, eval_data, n_epochs=1)
    assert state.step == int(jstate.step) == len(data)
    return dict(eng=eng, state=state, jstate=jstate, losses=losses,
                preds=[(top1, jtop1)])


@pytest.fixture(scope="module", params=["cossim", "epoch"])
def runs(request, weights):
    run = _cossim_runs if request.param == "cossim" else _epoch_runs
    return dict(run(weights), sd=weights[0])


def test_bf16_swin_losses_and_predictions_match_jax(runs):
    for i, (got, want) in enumerate(runs["losses"]):
        assert_losses(got, want, i)
    for got, want in runs["preds"]:
        assert got == want


def test_bf16_swin_ema_matches_jax(runs):
    assert_ema(runs["state"].ema, runs["jstate"].ema)


def test_bf16_swin_updates_match_jax(runs):
    _assert_updates(runs["eng"], runs["jstate"], runs["sd"])
