"""The port's trainer and analysis utilities (vitta_tpu_torch/adapt/train.py,
utils/analysis.py) against vitta_tpu's (adapt/train.py, utils/analysis.py).

The trainer's step is TANet's in batch-statistics mode (BatchNorm
normalising by the batch and updating its running statistics), which with
random weights is ill-conditioned in any float32 implementation: one
float32 ulp of the weights moves the port's own first gradients by a
median 34% at T 2, 32 x 32, 2 clips (layer4's BatchNorms then see 4 values
a channel), and its whole update at T 2, 64 x 64, 4 clips by 1-6% of its
norm, no less at 128 x 128 (tests/trainer_conditioning.py).  So the
trainer is held in two parts:

* the update rule, exactly: three steps at T 2, 32 x 32, 2 clips, each
  from the port's own gradients through vitta_tpu's optax chain (clip by
  global norm, decayed weights, momentum trace, -lr(count); the learning
  rate dropping at every step) against the port's ``clip_grad_norm_`` +
  ``torch.optim.SGD``: each parameter and momentum value within 2 float32
  ulps of the chain's, plus 1e-6 of the largest update or buffer value,
  with and without clipping;
* three steps against vitta_tpu's ``Trainer`` at T 2, 64 x 64, 4 clips,
  each from vitta_tpu's state before it (so that one step's conditioning
  does not compound into the next): the loss rtol 1e-3, top-1 exactly, the
  running statistics within 1e-3 of each layer's largest value, and the
  whole update and the whole momentum buffer each within SPREAD_FACTOR
  times the port's own largest one-ulp spread at that step (ULP_SEEDS),
  and never more than 10% of their norms.  vitta_tpu sums every
  convolution in another order, which moves every activation and not only
  the weights; with clipping its gap reads 1.6-2.7 times that spread
  (tests/trainer_conditioning.py).  Two planted faults, weight decay left
  out (13-19% of the update) and the TAM backward's kernel gradient
  reversed (40-57%), must read beyond the same bound at the first step,
  so that the check can fail.

Then ``step_decay_schedule`` at and around its boundaries against
vitta_tpu's (rtol 1e-6: float32 there), a checkpoint round trip bit for
bit (and ``<path>_best``), ``train_epoch``'s seeded dropout, and
``count_params`` / ``model_analysis`` / ``param_table`` against vitta_tpu's
counts for tiny TANet and a narrow Video Swin (shapes from
``jax.eval_shape``: nothing compiles).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt.train import Trainer as JaxTrainer
from vitta_tpu.adapt.train import step_decay_schedule as jax_schedule
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt.train import (TrainState, Trainer,
                                         restore_checkpoint, save_checkpoint,
                                         step_decay_schedule)
from vitta_tpu_torch.models.tanet import TANet
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

torch.set_num_threads(1)

T, K = 2, 5
LR = 1e-3
STEPS = 3
# the learning rate drops x0.1 after every step: a schedule off by one
# update moves every step's lr tenfold
SCHEDULE = dict(lr=LR, lr_steps=(1, 2), steps_per_epoch=1)
CLIPS = (None, 0.5)
ULP_SEEDS = (1, 2)
SPREAD_FACTOR = 4


def _weights():
    torch.manual_seed(0)
    oracle = TorchTSN(K, T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    return oracle.state_dict()


def _batches(hw, b, n=STEPS):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(b, T, hw, hw, 3)).astype(np.float32),
             (np.arange(b) + i) % K) for i in range(n)]


def _port_trainer(clip, dropout=0.0):
    return Trainer(TANet(K, clip_length=T, dropout=dropout),
                   clip_gradient=clip, device="cpu", **SCHEDULE)


def _trace(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.TraceState)).trace


def _within_ulps(got, want, step, what):
    """``got`` within 2 float32 ulps of ``want`` elementwise (the two
    chains round their sums at their own points), plus 1e-6 of the largest
    element of ``step``, the update or buffer they computed: an update
    applied in another order or at another step's learning rate misses by
    1e-3 of the update or more."""
    want, step = np.asarray(want), np.asarray(step)
    tol = 2 * np.spacing(np.abs(want)) + 1e-6 * np.abs(step).max()
    assert np.all(np.abs(got - want) <= tol), what


def _rel(got, want, scale):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(scale),
                                                  1e-30))


@pytest.mark.parametrize("clip", CLIPS)
def test_update_order_is_vitta_tpus_optax_chain(clip, monkeypatch):
    tx = JaxTrainer(None, clip_gradient=clip, **SCHEDULE).tx
    trainer = _port_trainer(clip)
    state = trainer.init_state(_weights())
    raw = {}
    real_clip = torch.nn.utils.clip_grad_norm_

    def recording_clip(params, max_norm):
        params = list(params)
        raw.update({id(p): p.grad.numpy().copy() for p in params})
        return real_clip(params, max_norm)

    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", recording_clip)
    names = {id(p): k for k, p in state.params.items()}
    params = {k: p.detach().numpy().copy() for k, p in state.params.items()}
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for x, y in _batches(32, 2):
        before = {k: p.detach().numpy().copy()
                  for k, p in state.params.items()}
        state, _metrics = trainer.train_step(state, x, y)
        grads = ({names[i]: g for i, g in raw.items()} if clip else
                 {k: p.grad.numpy().copy() for k, p in state.params.items()})
        if clip:
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads.values()))
            assert norm > 10 * clip   # the clip acts at every step
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        trace = _trace(opt_state)
        for k, p in state.params.items():
            _within_ulps(p.detach().numpy(), params[k], updates[k], k)
            _within_ulps(state.optimizer.state[p]["momentum_buffer"].numpy(),
                         trace[k], trace[k], k)
        params = {k: p.detach().numpy().copy()
                  for k, p in state.params.items()}
    assert state.step == STEPS


def _flat(d):
    return np.concatenate([np.ravel(v) for v in d])


@functools.lru_cache(maxsize=None)
def _vitta_tpu_steps(clip, hw=64):
    """vitta_tpu's ``Trainer`` over the three ``hw`` x ``hw`` batches of 4
    clips: its state
    before each step and after the last as the port's (state dict,
    momentum by name; no momentum before the first step), and each step's
    metrics."""
    sd = _weights()
    jt = JaxTrainer(JaxTANet(num_classes=K, clip_length=T, dropout=0.0),
                    clip_gradient=clip, **SCHEDULE)
    jstate = jt.init_state(convert_tanet_checkpoint(sd, K))
    snaps, metrics = [], []
    for i, (x, y) in enumerate(_batches(hw, 4)):
        # the step donates its input state: keep host copies
        snaps.append(jax.tree_util.tree_map(np.array, jstate))
        jstate, m = jt._step(jstate, jnp.asarray(x),
                             jnp.asarray(y.astype(np.int32)),
                             jax.random.PRNGKey(i))
        metrics.append([float(v) for v in m])
    snaps.append(jax.tree_util.tree_map(np.array, jstate))

    def port_sd(snap, params):
        return tanet_state_dict_from_jax({"params": params,
                                          "batch_stats": snap.batch_stats})

    return ([(port_sd(s, s.params),
              port_sd(s, _trace(s.opt_state)) if i else {})
             for i, s in enumerate(snaps)], metrics)


def _port_step(trainer, k, start, mom, hw=64):
    """The port's step ``k`` on the ``hw`` x ``hw`` batch from the state
    dict ``start`` and the momentum ``mom``: (state dict, momentum,
    metrics) after it."""
    x, y = _batches(hw, 4)[k]
    state = trainer.init_state(start)
    for n, p in state.params.items():
        if n in mom:
            state.optimizer.state[p]["momentum_buffer"] = mom[n].clone()
    state, metrics = trainer.train_step(dataclasses.replace(state, step=k),
                                        x, y)
    return ({n: v.clone() for n, v in trainer.model.state_dict().items()},
            {n: state.optimizer.state[p]["momentum_buffer"].clone()
             for n, p in state.params.items()},
            [float(v) for v in metrics])


def _gaps(run, run_start, want, start):
    """(update, momentum) of ``run`` from ``run_start`` against ``want``
    from ``start``, each over all parameters as one vector, relative to
    the norm of the wanted one."""
    names = list(run[1])   # the parameters
    upd = [_flat([sd[n].numpy() - s0[n].numpy() for n in names])
           for sd, s0 in ((run[0], run_start), (want[0], start))]
    mom = [_flat([m[n].numpy() for n in names]) for m in (run[1], want[1])]
    return tuple(_rel(a, b, b) for a, b in (upd, mom))


def _one_ulp_away(sd, seed):
    """``sd`` with every float tensor moved by one float32 ulp, a seeded
    random sign an element."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1.0 + torch.where(torch.rand(v.shape, generator=gen)
                                      < 0.5, 1.0, -1.0) * 2.0 ** -23)
            if v.is_floating_point() else v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _port_from_vitta_tpu(clip, k):
    """The port's step ``k`` from vitta_tpu's state before it."""
    start, mom = _vitta_tpu_steps(clip)[0][k]
    return _port_step(_port_trainer(clip), k, start, mom)


@functools.lru_cache(maxsize=None)
def _bound(clip, k):
    """(update, momentum): how far step ``k`` against vitta_tpu may read,
    SPREAD_FACTOR times the port's largest one-ulp spread (ULP_SEEDS), at
    most 10%."""
    snaps, _metrics = _vitta_tpu_steps(clip)
    start, mom = snaps[k]
    ref = _port_from_vitta_tpu(clip, k)
    spread = [0.0, 0.0]
    for seed in ULP_SEEDS:
        away = _one_ulp_away(start, seed)
        run = _port_step(_port_trainer(clip), k, away, mom)
        spread = [max(a, b) for a, b in
                  zip(spread, _gaps(run, away, ref, start))]
    return tuple(min(0.1, SPREAD_FACTOR * v) for v in spread)


@pytest.mark.parametrize("clip", CLIPS)
def test_steps_against_vitta_tpus_trainer(clip):
    snaps, metrics = _vitta_tpu_steps(clip)
    for k in range(STEPS):
        start, want = snaps[k][0], snaps[k + 1]
        run = _port_from_vitta_tpu(clip, k)
        got, _mom, (loss, top1, top5) = run
        jloss, jtop1, jtop5 = metrics[k]
        np.testing.assert_allclose(loss, jloss, rtol=1e-3)
        assert (top1, top5) == (jtop1, jtop5)
        for n, w in want[0].items():
            if n.endswith(("running_mean", "running_var")):
                err = np.abs(got[n].numpy() - w.numpy()).max()
                assert err <= 1e-3 * np.abs(w.numpy()).max(), (k, n)
        gaps, bound = _gaps(run, start, want, start), _bound(clip, k)
        assert all(g <= b for g, b in zip(gaps, bound)), (k, gaps, bound)


def _tam_kernel_gradient_reversed(monkeypatch):
    from vitta_tpu_torch.ops import cuda_tam
    backward = cuda_tam.TamPlain.backward

    def reversed_dkernel(ctx, g):
        dx, dattn, dkernel = backward(ctx, g)
        return dx, dattn, dkernel.flip(-1)

    monkeypatch.setattr(cuda_tam.TamPlain, "backward",
                        staticmethod(reversed_dkernel))
    return _port_trainer(0.5)


PLANTED = {
    "no_weight_decay": lambda _mp: Trainer(
        TANet(K, clip_length=T, dropout=0.0), clip_gradient=0.5,
        weight_decay=0.0, device="cpu", **SCHEDULE),
    "tam_kernel_gradient_reversed": _tam_kernel_gradient_reversed}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_the_step_bound_rejects_planted_faults(fault, monkeypatch):
    """With clipping (without it, the weights' decay is lost in the
    unclipped gradient), the first step of a trainer with a planted fault
    reads beyond ``_bound`` against vitta_tpu's in update and momentum."""
    _bound(0.5, 0)   # the spread of the sound port, before any patch
    snaps, _metrics = _vitta_tpu_steps(0.5)
    start, mom = snaps[0]
    run = _port_step(PLANTED[fault](monkeypatch), 0, start, mom)
    gaps, bound = _gaps(run, start, snaps[1], start), _bound(0.5, 0)
    assert all(g > b for g, b in zip(gaps, bound)), (gaps, bound)


def test_step_decay_schedule_matches_vitta_tpus():
    for lr_steps, spe in (((2, 4), 10), ((30, 60), 1000), ((3, 3), 7)):
        ours = step_decay_schedule(0.1, lr_steps, spe)
        theirs = jax_schedule(0.1, lr_steps, spe)
        bounds = [int(e * spe) for e in lr_steps]
        counts = {0, 1, 10 ** 6, *(b + d for b in bounds for d in (-1, 0, 1))}
        for c in sorted(counts):
            np.testing.assert_allclose(ours(c), float(theirs(c)), rtol=1e-6,
                                       err_msg=f"{lr_steps} {spe} {c}")
    sched = step_decay_schedule(1.0, (2, 4), 10)
    assert sched(19) == 1.0 and sched(20) == pytest.approx(0.1)
    assert sched(40) == pytest.approx(0.01)


def test_checkpoint_round_trip(tmp_path):
    trainer = _port_trainer(0.5)
    state = trainer.init_state(_weights())
    for x, y in _batches(32, 2, n=2):
        state, _m = trainer.train_step(state, x, y)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, keep_best=True, is_best=True)
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    momentum = {k: state.optimizer.state[p]["momentum_buffer"].clone()
                for k, p in state.params.items()}
    other = _port_trainer(0.5)
    fresh = other.init_state(_weights())
    for name in (path, path + "_best"):
        got = restore_checkpoint(name, target=fresh)
        assert isinstance(got, TrainState) and got.step == 2
        for k, v in other.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        for k, p in got.params.items():
            assert p is fresh.params[k]
            assert torch.equal(got.optimizer.state[p]["momentum_buffer"],
                               momentum[k]), k
    # the restored trainer goes on as the original does
    x, y = _batches(32, 2, n=3)[2]
    _s, (l1, _a, _b) = trainer.train_step(state, x, y)
    _s, (l2, _a, _b) = other.train_step(got, x, y)
    assert float(l1) == float(l2)
    # any dict of tensors and numbers round-trips as it is
    save_checkpoint(str(tmp_path / "plain"), {"w": torch.arange(3), "step": 7})
    raw = restore_checkpoint(str(tmp_path / "plain"))
    assert raw["step"] == 7 and torch.equal(raw["w"], torch.arange(3))
    assert not (tmp_path / "plain_best").exists()


def test_train_epoch_updates_bn_and_seeds_dropout():
    runs = []
    for _ in range(2):
        trainer = _port_trainer(None, dropout=0.8)
        state = trainer.init_state(_weights())
        m0 = state.batch_stats["base_model.bn1.running_mean"].clone()
        state, out = trainer.train_epoch(state, _batches(32, 2), seed=3)
        assert state.step == STEPS and np.isfinite(out["loss"])
        assert not torch.equal(m0,
                               state.batch_stats["base_model.bn1.running_mean"])
        runs.append({k: p.detach().clone() for k, p in state.params.items()})
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


def _swin_pair():
    """A narrow Video Swin in both packages: embed 16, depths (1, 1, 2, 1)."""
    from vitta_tpu.models.swin import Recognizer3D as JaxSwin
    from vitta_tpu_torch.models.swin import Recognizer3D
    kw = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
              window_size=(2, 3, 3))
    return JaxSwin(K, **kw), Recognizer3D(K, **kw), (1, 4, 48, 48, 3)


@pytest.mark.parametrize("arch", ["tanet", "swin"])
def test_analysis_counts_match_vitta_tpus(arch):
    from vitta_tpu.adapt.optim import tanet_trainable_mask as jax_mask
    from vitta_tpu.utils import analysis as jax_analysis
    from vitta_tpu_torch.adapt.optim import tanet_trainable_mask
    from vitta_tpu_torch.utils.analysis import (count_params, model_analysis,
                                                param_table)
    if arch == "tanet":
        jmodel, model, shape = (JaxTANet(num_classes=K, clip_length=T),
                                TANet(K, clip_length=T), (1, T, 32, 32, 3))
    else:
        jmodel, model, shape = _swin_pair()
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(
        lambda a: jmodel.init({"params": key, "dropout": key}, a,
                              train=False), jnp.zeros(shape))
    variables = {k: v for k, v in dict(variables).items()
                 if k in ("params", "batch_stats")}
    want = jax_analysis.model_analysis(variables)
    got = model_analysis(model)
    assert got == want
    assert count_params(model) == jax_analysis.count_params(
        variables["params"])
    if arch == "tanet":
        assert want["batch_stat_buffers"] > 0
        masked = model_analysis(
            model, trainable=tanet_trainable_mask(model.named_parameters()))
        want = jax_analysis.model_analysis(
            variables, trainable_mask=jax_mask(variables["params"]))
        assert masked == want
        assert masked["trainable_params"] < masked["total_params"]
        names = [k for k, on in tanet_trainable_mask(
            model.named_parameters()).items() if on]
        assert model_analysis(model, trainable=names) == want
        table = param_table(model, max_rows=5)
        assert table.splitlines()[0].startswith("base_model.conv1.weight")
        assert len(table.splitlines()) == 6
        assert "base_model.layer3_0.bn1.weight" in param_table(model)
    else:
        assert want["batch_stat_buffers"] == 0
        assert "backbone.layers_2" in param_table(model)
