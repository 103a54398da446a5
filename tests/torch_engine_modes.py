"""What the engine-mode parity tests of the port share: the tiny TANet of
tests/test_torch_engine.py (full-width ResNet-50+TAM at 32x32, dropout 0),
its weights in both packages' forms, seeded uint8 videos, a pair of engines
built from one configuration, and the comparison of two trajectories.

Tolerances are tests/test_torch_engine.py's, for the same reasons: losses
and the EMA rtol 1e-3 / atol 1e-5 (float32 convolutions summed in different
orders, then three steps on slightly different gradients); lr is raised to
1e-2 so that three steps move the weights far above float32 rounding, and
each tensor's update agrees with the JAX update to 2% of its norm;
predictions and top-1 / top-5 exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import tanet_ucf101_preset as jax_preset
from vitta_tpu.models.layers import tap_leaf_name
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

HW, K, V = 32, 5, 2
LR = 1e-2
RTOL, ATOL = 1e-3, 1e-5
N_STEPS = 3


def cfg_of(preset, t, lr=LR, optim=None, **tta):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, num_classes=K, dropout=0.0),
        optim=dataclasses.replace(cfg.optim, **{"lr": lr, **(optim or {})}),
        tta=dataclasses.replace(cfg.tta, **tta))


def tanet_weights(t):
    """(reference-keyed state dict, JAX variables) of a seeded TANet of
    ``t`` frames, running statistics away from their defaults."""
    torch.manual_seed(0)
    oracle = TorchTSN(K, t)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    return sd, convert_tanet_checkpoint(sd, K)


def jax_taps(variables, t, stat_types, leaf_type, bn1d=False):
    """{name: TapStats} of one tapped JAX forward of a seeded clean clip."""
    clean = np.random.default_rng(100).normal(size=(V, t, HW, HW, 3))
    _, aux = JaxTANet(num_classes=K, clip_length=t,
                      stat_types=stat_types).apply(
        variables, jnp.asarray(clean, jnp.float32), train=False,
        mutable=["taps"])
    return {n: s for n, s in jax_flatten_taps(
        aux["taps"], tap_leaf_name(leaf_type)).items()
        if bn1d or ("g_bn" not in n and "l_bn" not in n)}


def mean_var_source(variables, t):
    return {n: (np.asarray(s.mean), np.asarray(s.var))
            for n, s in jax_taps(variables, t, ("spatiotemp",),
                                 "spatiotemp").items()}


def videos(t, n=N_STEPS):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, t, HW, HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, t, HW, HW, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(n)]


def engines(sd, variables, src, t, tap_names=None, optim=None, **tta):
    """(JAX engine, port engine on the CPU) of one configuration."""
    jcfg = cfg_of(jax_preset, t, optim=optim, **tta)
    jeng = JaxEngine(JaxTANet(num_classes=K, clip_length=t, dropout=0.0,
                              stat_types=jcfg.tta.tap_stat_types()),
                     jcfg, variables, src, tap_names=tap_names, donate=False)
    cfg = cfg_of(tanet_ucf101_preset, t, optim=optim, **tta)
    eng = VittaEngine(get_model(cfg), cfg, sd, src, tap_names=tap_names,
                      device="cpu")
    return jeng, eng


def assert_ema_close(ema, jema):
    assert set(ema) == set(jema) and ema
    for name, stats in ema.items():
        for g, w in zip(stats, jema[name]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"ema {name}")


def assert_params_close(eng, jstate, sd, rel=2e-2, only=None):
    """Every parameter's update from the common initial weights against the
    JAX engine's, to ``rel`` of its norm; returns how many moved.  With
    ``only`` (a set of names) every other parameter must not have moved at
    all."""
    want = tanet_state_dict_from_jax({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats})
    got = eng.model.state_dict()
    moved = 0
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        init = sd[k].numpy()
        dj, dp = w.numpy() - init, got[k].numpy() - init
        if only is not None and k not in only:
            assert not dj.any() and not dp.any(), k
            continue
        assert np.linalg.norm(dp - dj) <= rel * np.linalg.norm(dj) + 1e-8, k
        moved += np.linalg.norm(dj) > 0
    return moved


def run_trajectories(jeng, eng, t, sd, steps=N_STEPS, rel=2e-2, only=None):
    """``steps`` adapt+eval steps of both engines on the same videos:
    metrics, EMA and, at the end, the parameters."""
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, (views, clip, label) in enumerate(videos(t, steps)):
        jstate, jm = jeng.adapt_eval_step(
            jstate, jnp.asarray(views), jnp.asarray(clip), jnp.asarray(label),
            jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            np.testing.assert_allclose(
                float(getattr(m, field)), float(getattr(jm, field)),
                rtol=RTOL, atol=ATOL, err_msg=f"{field} step {i}")
        for field in ("top1", "top5"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
        assert_ema_close(state.ema, jstate.ema)
    assert state.step == steps
    moved = assert_params_close(eng, jstate, sd, rel, only)
    return state, jstate, moved
