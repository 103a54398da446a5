"""The epoch-style loop of the port, ``tta_epoch_adapt`` (adapt-only steps
over the stream, then one ``validate`` pass), against the JAX package's on
the tiny TANet of tests/torch_engine_modes.py: the adapted parameters, the
EMA, the adapt-only step's losses and the final top-1.  Tolerances are that
file's (tests/test_torch_engine.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_engine_modes as tm
from vitta_tpu.adapt.loops import tta_epoch_adapt as jax_tta_epoch_adapt
from vitta_tpu_torch.adapt.loops import (tta_epoch_adapt, validate,
                                         video_seed)

torch.set_num_threads(1)

T = 2


@pytest.fixture(scope="module")
def pair():
    sd, variables = tm.tanet_weights(T)
    src = tm.mean_var_source(variables, T)
    return sd, tm.engines(sd, variables, src, T)


def test_adapt_step_matches_jax(pair):
    sd, (jeng, eng) = pair
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, (views, _clip, label) in enumerate(tm.videos(T)):
        jstate, jl = jeng.adapt_step(jstate, jnp.asarray(views),
                                     jnp.asarray(label),
                                     jax.random.fold_in(rng, i))
        state, losses = eng.adapt_step(state, views, label)
        assert len(losses) == 3
        for g, w, name in zip(losses, jl, ("reg", "consis", "ce")):
            np.testing.assert_allclose(float(g), float(w), rtol=tm.RTOL,
                                       atol=tm.ATOL, err_msg=f"{name} {i}")
        tm.assert_ema_close(state.ema, jstate.ema)
    assert state.step == tm.N_STEPS
    assert tm.assert_params_close(eng, jstate, sd) >= 100


def test_epoch_adapt_matches_jax(pair):
    sd, (jeng, eng) = pair
    data = tm.videos(T)
    eval_data = [(clip, label) for _views, clip, label in data]
    jdata = [tuple(jnp.asarray(a) for a in item) for item in data]
    jeval = [(jnp.asarray(c), np.asarray(l)) for c, l in eval_data]
    jtop1, jstate = jax_tta_epoch_adapt(jeng, jdata, jeval, n_epochs=2)
    top1, state = tta_epoch_adapt(eng, data, eval_data, n_epochs=2)
    assert state.step == 2 * len(data) == int(jstate.step)
    assert top1 == jtop1
    tm.assert_ema_close(state.ema, jstate.ema)
    assert tm.assert_params_close(eng, jstate, sd) >= 100
    # the pass at the end used the adapted parameters, and the live model
    # holds them
    assert validate(eng, eval_data, params=state.params)[0] == top1
    moved = sum(not torch.equal(p, eng.init_params[k])
                for k, p in state.params.items())
    assert moved >= 100


def test_epoch_adapt_takes_items_with_frames_and_label(pair):
    _sd, (_jeng, eng) = pair

    class Item:
        def __init__(self, frames, label):
            self.frames, self.label = frames, label

    data = tm.videos(T, 2)
    items = [Item(v, int(l[0])) for v, _c, l in data]
    eval_data = [(c, l) for _v, c, l in data]
    top1_a, state_a = tta_epoch_adapt(eng, items, eval_data)
    ema_a = {k: v.mean.clone() for k, v in state_a.ema.items()}
    top1_b, state_b = tta_epoch_adapt(eng, data, eval_data)
    assert top1_a == top1_b and state_a.step == state_b.step == 2
    for k, v in state_b.ema.items():
        assert torch.equal(v.mean, ema_a[k])


def test_epoch_adapt_seeds_each_step(pair, monkeypatch):
    """The dropout seed of step ``bi`` of epoch ``ep`` is
    ``video_seed(seed, ep * 100003 + bi)``."""
    _sd, (_jeng, eng) = pair

    class Recorder:        # dropout is 0: the generator is only seeded
        seen = []

        def manual_seed(self, s):
            self.seen.append(s)

    monkeypatch.setattr(eng, "generator", Recorder())
    data = tm.videos(T, 2)
    tta_epoch_adapt(eng, data, [(c, l) for _v, c, l in data], n_epochs=2,
                    seed=9)
    assert Recorder.seen == [video_seed(9, e * 100003 + b) for e in range(2)
                             for b in range(2)]
