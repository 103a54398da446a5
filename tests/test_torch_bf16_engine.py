"""3-step ViTTA trajectories of the port's engine at bfloat16 against the
JAX ``VittaEngine`` at bfloat16 (``compute_dtype="bfloat16"``), from the
same float32 weights, source statistics and uint8 videos: T = 2, 32 x 32,
full-width ResNet-50+TAM, dropout 0, lr 1e-2, as tests/test_torch_engine.py
at float32.  Both keep float32 masters and float32 SGD.

Tolerances, and why.  At float32 the two engines agree to 1e-4 of each
update (tests/test_torch_engine.py holds them to 2%).  At bfloat16 each
rounds its activations, and the JAX engine, one compiled program, skips
some of the roundings between fused ops that the port makes; at this size
the features carry the difference into the sum-L1 consistency loss, whose
gradient is the sign of each logit difference between the two views, and
into the TAM's global-branch BatchNorm, whose bias gradient is a sum that
cancels.  Measured: the whole update (every parameter, as one vector) 3.5%
apart (JAX's own bfloat16 update is 1.6% from its float32 one), the median
tensor 0.3%, the worst (``new_fc``, through the consistency signs) 63%.  So:
* losses: reg and ce rtol 1e-3; consistency atol 2e-4 (an L1 sum of logit
  differences that bfloat16 moves by ~4e-4 a logit; measured 8e-5);
  predictions and top-1 / top-5 exactly;
* the EMA: each layer's mean within 1e-2 of its largest magnitude
  (measured 2.8e-3); its variance at rtol 2e-2 / atol 1e-2 of the layer's
  largest v + m^2: a variance is E[y^2] - m^2 of bfloat16 values, and one
  ulp on every y moves E[y^2] by up to 2^-7 of it, whatever v is (layer4's
  variances over 4 positions are 1e-5 of m^2 here; measured: 1.2e-5 of
  m^2 beyond the rtol);
* parameters: the whole update within ``WHOLE`` (5%) of its norm, the
  median tensor's within 2% (the float32 tests' share), every tensor's
  within ``EACH`` (75%) and every tensor that JAX moves moved by the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import tanet_ucf101_preset as jax_preset
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

torch.set_num_threads(1)

T, HW, K, V = 2, 32, 5, 2
LR = 1e-2
N_STEPS = 3
WHOLE, MEDIAN, EACH = 5e-2, 2e-2, 0.75


def _cfg(preset):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, num_classes=K, dropout=0.0,
                                  compute_dtype="bfloat16"),
        optim=dataclasses.replace(cfg.optim, lr=LR))


def _videos():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(N_STEPS)]


@pytest.fixture(scope="module")
def runs():
    """Both engines' metrics, EMA and final weights after N_STEPS."""
    torch.manual_seed(0)
    oracle = TorchTSN(K, T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    variables = convert_tanet_checkpoint(sd, K)
    # the source: one float32 tapped forward of a seeded clean clip
    clean = np.random.default_rng(100).normal(size=(V, T, HW, HW, 3))
    _, aux = JaxTANet(num_classes=K, clip_length=T).apply(
        variables, jnp.asarray(clean, jnp.float32), train=False,
        mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"], "stat").items()
           if "g_bn" not in n and "l_bn" not in n}
    jeng = JaxEngine(JaxTANet(num_classes=K, clip_length=T, dropout=0.0,
                              dtype="bfloat16"),
                     _cfg(jax_preset), variables, src, donate=False)
    cfg = _cfg(tanet_ucf101_preset)
    eng = VittaEngine(get_model(cfg), cfg, sd, src, device="cpu")
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    metrics = []
    for i, (views, clip, label) in enumerate(_videos()):
        jstate, jm = jeng.adapt_eval_step(jstate, jnp.asarray(views),
                                          jnp.asarray(clip),
                                          jnp.asarray(label),
                                          jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        metrics.append((m, jm))
    want = tanet_state_dict_from_jax({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats})
    return dict(sd=sd, eng=eng, state=state, jstate=jstate, metrics=metrics,
                want=want)


def test_engine_runs_at_bf16_with_float32_masters(runs):
    eng = runs["eng"]
    assert eng.model.dtype == torch.bfloat16
    for name, p in eng.model.named_parameters():
        assert p.dtype == torch.float32, name
    for group in eng.optimizer.param_groups:
        for p in group["params"]:
            for v in eng.optimizer.state[p].values():
                if torch.is_tensor(v) and v.is_floating_point():
                    assert v.dtype == torch.float32
    for m, _jm in runs["metrics"]:
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            assert getattr(m, field).dtype == torch.float32, field
    for stats in runs["state"].ema.values():
        assert stats.mean.dtype == stats.var.dtype == torch.float32


def test_losses_and_predictions_match_jax_bf16(runs):
    for i, (m, jm) in enumerate(runs["metrics"]):
        for field in ("loss_reg", "loss_ce"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jm, field)), rtol=1e-3,
                                       err_msg=f"{field} step {i}")
        np.testing.assert_allclose(float(m.loss_consis),
                                   float(jm.loss_consis), rtol=0, atol=2e-4,
                                   err_msg=f"loss_consis step {i}")
        for field in ("top1", "top5"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()


def test_ema_matches_jax_bf16(runs):
    ema, jema = runs["state"].ema, runs["jstate"].ema
    assert set(ema) == set(jema) and ema
    for name, (gm, gv) in ema.items():
        wm, wv = (np.asarray(v) for v in jema[name])
        scale = float(np.abs(wm).max())
        np.testing.assert_allclose(gm.numpy(), wm, rtol=0,
                                   atol=1e-2 * scale, err_msg=f"ema {name}")
        second = float((np.abs(wv) + wm ** 2).max())   # E[y^2]'s size
        np.testing.assert_allclose(gv.numpy(), wv, rtol=2e-2,
                                   atol=1e-2 * second,
                                   err_msg=f"ema var {name}")


def test_updates_match_jax_bf16(runs):
    sd, want = runs["sd"], runs["want"]
    got = runs["eng"].model.state_dict()
    diffs, norms, each = [], [], []
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        init = sd[k].numpy().astype(np.float64)
        dj = w.numpy() - init
        dp = got[k].numpy() - init
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
