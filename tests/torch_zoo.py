"""Seeded weights and shared set-up for the model-zoo parity tests
(tests/test_torch_zoo_cnn.py, tests/test_torch_zoo_videomae.py).

The JAX model's variables are made from its shapes alone
(``jax.eval_shape`` of ``init``: nothing is compiled) and drawn with numpy
from a seed: He-scaled kernels, norm scales near 1, small biases, and
random running statistics, so that no BatchNorm is the identity.  The
port's weights are those variables carried across by the
``*_state_dict_from_jax`` functions under test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import tanet_ucf101_preset as jax_preset
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.models.layers import flatten_taps


def seeded_variables(model, x, seed=0, gain=1.0, **call_kw):
    """{"params", "batch_stats"} of the flax ``model`` for inputs shaped
    like ``x``, as numpy arrays drawn from ``seed``; ``call_kw`` are the
    model's call arguments (by default ``train=False``)."""
    key = jax.random.PRNGKey(0)
    call_kw = call_kw or {"train": False}
    shapes = jax.eval_shape(
        lambda a: model.init({"params": key, "dropout": key}, a, **call_kw),
        jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        col, name = path[0].key, path[-1].key
        shape = s.shape
        if col == "batch_stats":
            if name == "mean":
                return rng.normal(0.0, 0.1, shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, np.sqrt(gain / fan_in),
                              shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(
        draw, {k: v for k, v in dict(shapes).items()
               if k in ("params", "batch_stats")})
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats", {})}


def clip(seed, b, t, hw):
    return np.random.default_rng(seed).normal(
        size=(b, t, hw, hw, 3)).astype(np.float32)


def assert_taps_match(taps, aux, rtol, atol):
    """Every tap leaf of the port's tap dict (names, means, variances,
    both sides) against vitta_tpu's ``taps`` collection; returns how many
    layers were compared."""
    for leaf in ("stat", "stat_in"):
        want = jax_flatten_taps(aux["taps"], leaf)
        got = flatten_taps(taps, leaf)
        assert set(got) == set(want) and want, leaf
        for name, stats in want.items():
            for g, w in zip(got[name], stats):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{leaf} {name}")
    counts = jax_flatten_taps(aux["taps"], "stat_n")
    assert {n: float(v) for n, v in counts.items()} == \
        flatten_taps(taps, "stat_n")
    return len(want)


def zoo_cfgs(arch, t, hw, k, chosen, lr=1e-2, **tta):
    """vitta_tpu's and the port's TANet preset configured for ``arch`` at
    ``t`` frames of ``hw``, ``k`` classes, the ``chosen`` blocks, ``lr``
    and ``tta`` overrides (the model zoo takes the TANet preset, as both
    packages' config_from_args do)."""
    out = []
    for preset in (jax_preset, tanet_ucf101_preset):
        cfg = preset()
        out.append(cfg.replace(
            data=dataclasses.replace(cfg.data, clip_length=t, input_size=hw,
                                     scale_size=hw),
            model=dataclasses.replace(cfg.model, arch=arch, num_classes=k,
                                      dropout=0.0),
            optim=dataclasses.replace(cfg.optim, lr=lr),
            tta=dataclasses.replace(cfg.tta, chosen_blocks=chosen, **tta)))
    return out


def source_stats(jmodel, variables, t, hw, views=2):
    """{name: (mean, var)} of every output-side tap from one tapped
    forward of a seeded clean clip through the JAX model."""
    _, aux = jmodel.apply(variables, jnp.asarray(clip(100, views, t, hw)),
                          train=False, mutable=["taps"])
    return {n: (np.asarray(s.mean), np.asarray(s.var))
            for n, s in jax_flatten_taps(aux["taps"]).items()}


def uint8_videos(n, t, hw, k, views=2, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (views, t, hw, hw, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8),
             np.asarray([i % k], np.int32)) for i in range(n)]


def assert_trajectories_match(jeng, eng, videos, sd0, convert, rtol, atol,
                              rel):
    """``len(videos)`` adapt+eval steps of the JAX engine and the port's
    from the same state: losses and the EMA at rtol / atol, predictions
    and top-1 / top-5 exactly, then every parameter's update within
    ``rel`` of the JAX update's norm (``convert`` takes the JAX params and
    batch_stats to the port's state dict) and the running statistics at
    rtol / 5e-5.  Returns the number of parameters that moved."""
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, (views, clip_, label) in enumerate(videos):
        jstate, jm = jeng.adapt_eval_step(
            jstate, jnp.asarray(views), jnp.asarray(clip_),
            jnp.asarray(label), jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip_, label)
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jm, field)), rtol=rtol,
                                       atol=atol, err_msg=f"{field} {i}")
        for field in ("top1", "top5"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
        assert set(state.ema) == set(jstate.ema) and state.ema
        for name, stats in state.ema.items():
            for g, w in zip(stats, jstate.ema[name]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=rtol, atol=atol,
                                           err_msg=f"ema {name}")
    want = convert({"params": jstate.params,
                    "batch_stats": jstate.batch_stats})
    got = eng.model.state_dict()
    moved = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w0 = got[k].numpy(), w.numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w0, rtol=rtol, atol=5e-5, err_msg=k)
            continue
        init = sd0[k].numpy()
        dj, dp = w0 - init, g - init
        assert np.linalg.norm(dp - dj) <= rel * np.linalg.norm(dj) + 1e-8, k
        moved += np.linalg.norm(dj) > 0
    return moved
