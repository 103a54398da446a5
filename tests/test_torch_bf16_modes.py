"""The bfloat16 TANet (``compute_dtype="bfloat16"``) under the engine's
other modes against the JAX ``VittaEngine`` at bfloat16: 3-step
trajectories under ``stat_reg="BNS"`` and ``"cossim"``, and
``tta_epoch_adapt`` (adapt-only steps, then one ``validate`` pass), from
the same float32 weights and uint8 videos as tests/torch_engine_modes.py
(full-width ResNet-50+TAM at 32 x 32, dropout 0, lr 1e-2); T = 2, and T = 4
under cossim (six frame pairs a layer, as tests/test_torch_engine_cossim
.py).  Both keep float32 masters and float32 SGD.

Tolerances are tests/test_torch_bf16_engine.py's, for its reasons (each
engine rounds its activations at its own points, and the consistency
loss's gradient is the sign of each logit difference): reg and ce losses
rtol 1e-3, consistency atol 2e-4, predictions and top-1 / top-5 exactly;
each EMA layer's mean within 1e-2 of its largest magnitude, its variance
at rtol 2e-2 / atol 1e-2 of the layer's largest v + m^2; the whole update
within 5% of its norm, the median tensor's within 2%, every tensor's
within 75%, and every tensor that JAX moves moved by the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_engine_modes as tm
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.loops import tta_epoch_adapt as jax_tta_epoch_adapt
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.adapt.loops import tta_epoch_adapt
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

torch.set_num_threads(1)

WHOLE, MEDIAN, EACH = 5e-2, 2e-2, 0.75
COSSIM = dict(stat_reg="cossim", stat_type=("temp",))


def _bf16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 compute_dtype="bfloat16"))


def engines(t, src, **tta):
    """(JAX engine, port engine on the CPU) of the bfloat16 TANet."""
    sd, variables = tm.tanet_weights(t)
    jcfg = _bf16(tm.cfg_of(tm.jax_preset, t, **tta))
    jeng = JaxEngine(JaxTANet(num_classes=tm.K, clip_length=t, dropout=0.0,
                              dtype="bfloat16",
                              stat_types=jcfg.tta.tap_stat_types()),
                     jcfg, variables, src(variables) if src else None,
                     donate=False)
    cfg = _bf16(tm.cfg_of(tm.tanet_ucf101_preset, t, **tta))
    eng = VittaEngine(get_model(cfg), cfg, sd,
                      src(variables) if src else None, device="cpu")
    assert eng.model.dtype == torch.bfloat16
    assert eng.tap_names == tuple(jeng.tap_names) and eng.tap_names
    return sd, jeng, eng


def assert_losses(losses, jlosses, step):
    reg, consis, ce = (float(v) for v in losses)
    jreg, jconsis, jce = (float(v) for v in jlosses)
    np.testing.assert_allclose(reg, jreg, rtol=1e-3, err_msg=f"reg {step}")
    np.testing.assert_allclose(ce, jce, rtol=1e-3, err_msg=f"ce {step}")
    np.testing.assert_allclose(consis, jconsis, rtol=0, atol=2e-4,
                               err_msg=f"consis {step}")


def assert_ema(ema, jema):
    assert set(ema) == set(jema) and ema
    for name, (gm, gv) in ema.items():
        wm, wv = (np.asarray(v) for v in jema[name])
        np.testing.assert_allclose(gm.numpy(), wm, rtol=0,
                                   atol=1e-2 * float(np.abs(wm).max()),
                                   err_msg=f"ema {name}")
        second = float((np.abs(wv) + wm ** 2).max())
        np.testing.assert_allclose(gv.numpy(), wv, rtol=2e-2,
                                   atol=1e-2 * second,
                                   err_msg=f"ema var {name}")


def assert_updates(eng, jstate, sd):
    want = tanet_state_dict_from_jax({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats})
    got = eng.model.state_dict()
    diffs, norms, each = [], [], []
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        init = sd[k].numpy().astype(np.float64)
        dj, dp = w.numpy() - init, got[k].numpy() - init
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
    assert len(each) >= 100


def _cossim_source(t):
    def src(variables):
        out = {n: np.asarray(s.mean) for n, s in tm.jax_taps(
            variables, t, ("cossim",), "cossim", bn1d=True).items()}
        out["base_model.layer3_0.tam.g_bn"] = None
        return out
    return src


MODES = {   # name: (T, source, tta overrides)
    "BNS": (2, None, dict(stat_reg="BNS")),
    "cossim": (4, _cossim_source(4), COSSIM),
    "epoch": (2, None, dict()),
}


def _epoch_runs(t):
    """tta_epoch_adapt's adapt-only steps one by one (their losses), then
    the loop itself: two epochs and the evaluation pass."""
    sd, jeng, eng = engines(t, lambda v: tm.mean_var_source(v, t))
    data = tm.videos(t)
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
        n_epochs=2)
    top1, state = tta_epoch_adapt(eng, data, eval_data, n_epochs=2)
    assert state.step == int(jstate.step) == 2 * len(data)
    return dict(sd=sd, eng=eng, state=state, jstate=jstate, losses=losses,
                preds=[(top1, jtop1)])


@pytest.fixture(scope="module", params=list(MODES))
def runs(request):
    """Both engines' losses, predictions, EMA and final weights."""
    t, src, tta = MODES[request.param]
    if request.param == "epoch":
        return _epoch_runs(t)
    sd, jeng, eng = engines(t, src, **tta)
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    losses, preds = [], []
    for i, (views, clip, label) in enumerate(tm.videos(t)):
        jstate, jm = jeng.adapt_eval_step(
            jstate, jnp.asarray(views), jnp.asarray(clip), jnp.asarray(label),
            jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        losses.append(((m.loss_reg, m.loss_consis, m.loss_ce),
                       (jm.loss_reg, jm.loss_consis, jm.loss_ce)))
        preds.append(([float(m.top1), float(m.top5), m.pred.tolist()],
                      [float(jm.top1), float(jm.top5),
                       np.asarray(jm.pred).tolist()]))
    assert state.step == tm.N_STEPS
    return dict(sd=sd, eng=eng, state=state, jstate=jstate, losses=losses,
                preds=preds)


def test_bf16_losses_and_predictions_match_jax(runs):
    for i, (got, want) in enumerate(runs["losses"]):
        assert_losses(got, want, i)
    for got, want in runs["preds"]:
        assert got == want


def test_bf16_ema_matches_jax(runs):
    assert_ema(runs["state"].ema, runs["jstate"].ema)


def test_bf16_updates_match_jax(runs):
    assert_updates(runs["eng"], runs["jstate"], runs["sd"])
