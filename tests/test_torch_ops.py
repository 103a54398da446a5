"""vitta_tpu_torch.ops.{stats,losses} and vitta_tpu_torch.config against
the JAX package: the same numpy inputs go through both.

Tolerance: rtol 1e-6 on float32 reductions, with atol 1e-7 for entries
near zero (a mean of centred data), where a relative bound means nothing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu import config as jcfg
from vitta_tpu.ops import losses as jlosses
from vitta_tpu.ops import stats as jstats
from vitta_tpu_torch import config as tcfg
from vitta_tpu_torch.ops import losses as tlosses
from vitta_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("stat_type", ["spatiotemp", "spatial", "temp",
                                       "temp_v2"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 5, 8), (3, 2, 4, 4, 16)])
def test_channel_stats_matches_jax(stat_type, shape):
    x = np.random.default_rng(0).normal(0.3, 1.2, size=shape).astype(np.float32)
    want = jstats.channel_stats(jnp.asarray(x), stat_type=stat_type,
                                time_axis=1)
    got = tstats.channel_stats(torch.from_numpy(x), stat_type=stat_type,
                               time_axis=1)
    _close(got.mean, want.mean)
    _close(got.var, want.var)


def test_channel_stats_rank2_and_4():
    rng = np.random.default_rng(1)
    for shape in [(12, 7), (6, 3, 3, 16)]:
        x = rng.normal(size=shape).astype(np.float32)
        want = jstats.channel_stats(jnp.asarray(x))
        got = tstats.channel_stats(torch.from_numpy(x))
        _close(got.mean, want.mean)
        _close(got.var, want.var)


def _stats(rng, c=6):
    return (rng.normal(size=c).astype(np.float32),
            rng.uniform(0.5, 2.0, size=c).astype(np.float32))


def test_ema_update_values_and_detach():
    rng = np.random.default_rng(2)
    (em, ev), (bm, bv) = _stats(rng), _stats(rng)
    want = jstats.ema_update(jstats.TapStats(em, ev),
                             jstats.TapStats(bm, bv), 0.1)
    ema = tstats.TapStats(torch.tensor(em, requires_grad=True),
                          torch.tensor(ev, requires_grad=True))
    batch = tstats.TapStats(torch.tensor(bm, requires_grad=True),
                            torch.tensor(bv, requires_grad=True))
    got = tstats.ema_update(ema, batch, 0.1)
    _close(got.mean.detach(), want.mean)
    _close(got.var.detach(), want.var)
    (got.mean.sum() + got.var.sum()).backward()
    assert ema.mean.grad is None and ema.var.grad is None
    _close(batch.mean.grad, np.full(6, 0.1, np.float32))


def test_cumulative_update_values_and_detach():
    rng = np.random.default_rng(3)
    (sm, sv), (bm, bv) = _stats(rng), _stats(rng)
    jstate = jstats.CumulativeState(sm, sv, jnp.float32(4.0))
    jnew, javg = jstats.cumulative_update(jstate, jstats.TapStats(bm, bv), 2.0)
    state = tstats.CumulativeState(torch.tensor(sm, requires_grad=True),
                                   torch.tensor(sv, requires_grad=True),
                                   torch.tensor(4.0))
    batch = tstats.TapStats(torch.tensor(bm, requires_grad=True),
                            torch.tensor(bv))
    new, avg = tstats.cumulative_update(state, batch, 2.0)
    for g, w in zip((*new, *avg), (*jnew, *javg)):
        _close(g.detach(), w)
    avg.mean.sum().backward()
    assert state.sum_mean.grad is None
    _close(batch.mean.grad, np.full(6, 2.0 / 6.0, np.float32))


@pytest.mark.parametrize("reg_type", ["l1_loss", "mse_loss", "kld"])
def test_compute_regularization(reg_type):
    rng = np.random.default_rng(4)
    src, est = _stats(rng, 32), _stats(rng, 32)
    want = jlosses.compute_regularization(jstats.TapStats(*src),
                                          jstats.TapStats(*est), reg_type)
    got = tlosses.compute_regularization(
        tstats.TapStats(*map(torch.from_numpy, src)),
        tstats.TapStats(*map(torch.from_numpy, est)), reg_type)
    _close(got, want)


def test_pred_consistency_and_entropy():
    logits = np.random.default_rng(5).normal(size=(3, 2, 11)).astype(np.float32)
    _close(tlosses.pred_consistency(torch.from_numpy(logits)),
           jlosses.pred_consistency(jnp.asarray(logits)))
    flat = logits.reshape(6, 11)
    _close(tlosses.softmax_entropy(torch.from_numpy(flat)),
           jlosses.softmax_entropy(jnp.asarray(flat)))


def test_cross_entropy_and_topk():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 9)).astype(np.float32)
    labels = rng.integers(0, 9, size=5).astype(np.int32)
    _close(tlosses.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)),
           jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    for g, w in zip(tlosses.topk_accuracy(torch.from_numpy(logits),
                                          torch.from_numpy(labels)),
                    jlosses.topk_accuracy(jnp.asarray(logits),
                                          jnp.asarray(labels))):
        _close(g, w)


@pytest.mark.parametrize("name", ["DataConfig", "ModelConfig", "OptimConfig",
                                  "TTAConfig", "RuntimeConfig", "VittaConfig"])
def test_config_dataclasses_equal_jax(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    assert tf == jf
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())


@pytest.mark.parametrize("preset", ["tanet_ucf101_preset",
                                    "swin_ucf101_preset"])
def test_presets_equal_jax(preset):
    want = dataclasses.asdict(getattr(jcfg, preset)())
    assert dataclasses.asdict(getattr(tcfg, preset)()) == want
    assert tcfg.CORRUPTIONS == jcfg.CORRUPTIONS
