"""3-step ViTTA trajectories of the port's engine against the JAX
``VittaEngine``, from the same weights, source statistics and uint8
videos (T=2, 32x32, full-width ResNet-50+TAM, dropout 0 so that no random
numbers enter).

The batch-stat BN mode (fix_BNS off) is ill-conditioned at this size
with random weights: its weight gradients differ between JAX and
torch's own ``nn.BatchNorm2d`` (tests/torch_tanet.py in train mode) by
~5% of their norm, and the port's lie between the two.  So that mode
runs one step at 64x64 and the preset lr, and compares what its forward
decides — losses, EMA, running statistics, eval predictions — while the
BN and TAM gradients in batch-stat form are compared module by module
in tests/test_torch_tam.py.

Tolerances, and why:
* losses and the EMA: rtol 1e-3 / atol 1e-5.  Both sides run float32
  convs that sum in different orders (oneDNN against XLA:CPU); after the
  forward the taps agree to ~1e-5 relative, and three SGD steps on
  slightly different gradients move them a little further apart.
* weights: the test raises lr to 1e-2 so that three steps move the
  weights far above float32 rounding; each tensor's update then agrees
  with the JAX update to 2% of its norm.  Running statistics agree at
  rtol 1e-3 / atol 5e-5: a running mean near zero carries the absolute
  error of the O(1) activations it averages.
* predictions and top-1/top-5: exactly.
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
from vitta_tpu.models.layers import tap_leaf_name
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine, select_tap_names
from vitta_tpu_torch.adapt.loops import tta_stream
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

torch.set_num_threads(1)

T, HW, K, V = 2, 32, 5, 2
LR = 1e-2
RTOL, ATOL = 1e-3, 1e-5
N_STEPS = 3


def _cfg(preset, dropout=0.0, lr=LR, **tta):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, num_classes=K, dropout=dropout),
        optim=dataclasses.replace(cfg.optim, lr=lr),
        tta=dataclasses.replace(cfg.tta, **tta))


MODES = {   # name: (tta overrides, frame size, steps, lr)
    "online": (dict(), HW, N_STEPS, LR),
    "online_two_stat_types": (dict(stat_type=("spatiotemp", "temp")), HW,
                              N_STEPS, LR),
    "online_cumulative_meter": (dict(moving_avg=False), HW, N_STEPS, LR),
    "standard": (dict(if_tta_standard="tta_standard", momentum_mvg=1.0,
                      n_gradient_steps=2), HW, N_STEPS, LR),
    "online_batch_stat_bn": (dict(fix_BNS=False), 2 * HW, 1, 5e-5),
}


def _source_stats(variables, hw, stat_types=("spatiotemp",)):
    """Source statistics from one tapped forward of a seeded clip:
    {name: (mean, var)} for one type, {type: {name: ...}} for several."""
    clean = np.random.default_rng(100).normal(size=(V, T, hw, hw, 3))
    _, aux = JaxTANet(num_classes=K, clip_length=T,
                      stat_types=stat_types).apply(
        variables, jnp.asarray(clean, jnp.float32), train=False,
        mutable=["taps"])
    per_type = {
        st: {n: (np.asarray(s.mean), np.asarray(s.var))
             for n, s in jax_flatten_taps(aux["taps"],
                                          tap_leaf_name(st)).items()
             if "g_bn" not in n and "l_bn" not in n}
        for st in stat_types}
    return per_type if len(stat_types) > 1 else per_type[stat_types[0]]


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    oracle = TorchTSN(K, T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    variables = convert_tanet_checkpoint(sd, K)
    return sd, variables, _source_stats(variables, HW)


def _videos(n=N_STEPS, hw=HW):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, hw, hw, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, hw, hw, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(n)]


def _port_engine(weights, dropout=0.0, lr=LR, **tta):
    sd, _variables, src = weights
    cfg = _cfg(tanet_ucf101_preset, dropout, lr, **tta)
    return VittaEngine(get_model(cfg), cfg, sd, src)


def test_select_tap_names(weights):
    eng = _port_engine(weights)
    assert len(eng.tap_names) == 29   # 19 BN2d in layer3 + 10 in layer4
    assert eng.tap_names == select_tap_names(weights[2], ("layer3", "layer4"),
                                             weights[2])


@pytest.mark.parametrize("mode", list(MODES))
def test_trajectory_matches_jax(weights, mode):
    sd, variables, src = weights
    tta, hw, steps, lr = MODES[mode]
    stat_types = tta.get("stat_type", ("spatiotemp",))
    if (hw, stat_types) != (HW, ("spatiotemp",)):
        src = _source_stats(variables, hw, stat_types)
    jeng = JaxEngine(JaxTANet(num_classes=K, clip_length=T, dropout=0.0,
                              stat_types=stat_types),
                     _cfg(jax_preset, lr=lr, **tta), variables, src,
                     donate=False)
    eng = _port_engine((sd, variables, src), lr=lr, **tta)
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, (views, clip, label) in enumerate(_videos(steps, hw)):
        jstate, jm = jeng.adapt_eval_step(jstate, jnp.asarray(views),
                                          jnp.asarray(clip),
                                          jnp.asarray(label),
                                          jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jm, field)), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{field} step {i}")
        for field in ("top1", "top5"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
        if mode == "standard":
            continue   # the JAX state after a tta_standard step is the reset one
        ema, jema = state.ema, jstate.ema
        if len(stat_types) > 1:   # {stat_type: {name: stats}}
            assert set(ema) == set(jema)
            ema = {f"{st}/{n}": v for st in ema for n, v in ema[st].items()}
            jema = {f"{st}/{n}": v for st in jema for n, v in jema[st].items()}
        assert set(ema) == set(jema) and ema
        for name, stats in ema.items():
            for g, w in zip(stats, jema[name]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                           atol=ATOL, err_msg=f"ema {name}")
    assert state.step == steps
    if mode == "standard":
        return
    want = tanet_state_dict_from_jax({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats})
    got = eng.model.state_dict()
    moved = n_params = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w0 = got[k].numpy(), w.numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w0, rtol=RTOL, atol=5e-5, err_msg=k)
            continue
        if lr != LR:
            continue
        n_params += 1
        init = sd[k].numpy()
        dj, dp = w0 - init, g - init
        # (a tensor whose gradient is exactly 0 on both sides stays put)
        assert np.linalg.norm(dp - dj) <= 2e-2 * np.linalg.norm(dj) + 1e-8, k
        moved += np.linalg.norm(dj) > 0
    assert lr != LR or moved >= 0.95 * n_params


def test_standard_mode_resets_per_video(weights):
    eng = _port_engine(weights, **MODES["standard"][0])
    views, clip, label = _videos(1)[0]
    state = eng.init_state()
    state, m1 = eng.adapt_eval_step(state, views, clip, label)
    state, m2 = eng.adapt_eval_step(state, views, clip, label)
    assert float(m1.loss_reg) == float(m2.loss_reg)
    assert float(m1.loss_consis) == float(m2.loss_consis)


def test_dropout_draws_from_engine_generator(weights):
    eng = _port_engine(weights, dropout=0.8)
    views, clip, label = _videos(1)[0]
    global_rng = torch.get_rng_state()

    def run(seed):
        state = eng.init_state()
        eng.generator.manual_seed(seed)
        _, m = eng.adapt_eval_step(state, views, clip, label)
        return float(m.loss_consis), float(m.loss_reg)

    first, again, other = run(1), run(1), run(2)
    assert first == again
    assert first[0] != other[0]        # dropout moves the logits
    assert torch.equal(torch.get_rng_state(), global_rng)


def test_tta_stream_is_reproducible(weights):
    eng = _port_engine(weights, dropout=0.8)
    data = _videos()
    top1_a, _, meters_a = tta_stream(eng, data, seed=3)
    top1_b, state, meters_b = tta_stream(eng, data, seed=3)
    assert state.step == len(data)
    assert top1_a == top1_b
    for k in ("loss_reg", "loss_consis", "loss_ce"):
        assert meters_a[k].avg == meters_b[k].avg
        assert np.isfinite(meters_a[k].avg)
