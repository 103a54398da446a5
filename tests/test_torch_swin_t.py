"""A narrow Video Swin of Swin-T's shape through the port as a whole, on the
CPU, against the JAX package: the widths whose blocks run norm2 and the MLP
apart, and the attention route per (head, window).

Swin-T is embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24); here embed
48, depths (2, 2, 2, 1), the same heads (head dim 16), window (2, 3, 3),
clips of 4 x 48 x 48.  The widths are 48, 96, 192 and 384: the first three
are no multiple of 128, so their blocks take the LayerNorm op and ``mlp``
(vitta_tpu_torch/ops/dispatch.py: ``mlp_ln_fused``), the last is, and its
block takes ``ln_mlp``.  The second blocks of stages 1 and 2 are shifted
(16 and 4 mask windows), stage 3 holds one full window, stage 4 is clamped
and keeps the plain attention.  The port runs under ``attn_route="packed"``
and ``"heads"``; the JAX package has no flag for the latter (it takes that
route from a memory estimate that means nothing off the TPU), and on the
CPU all its routes are the same jnp math, so one JAX run is the reference
of both.  Weights cross through ``convert_swin_checkpoint`` /
``swin_state_dict_from_jax``; drop-path and dropout are off, so no random
numbers enter.

Tolerances are those of tests/test_torch_swin.py and
tests/test_torch_swin_engine.py, for the same reasons (float32 products
summed in different orders through the blocks): logits rtol 2e-3 / atol
2e-4; tap and source statistics rtol 1e-3 / atol 1e-5; losses and the EMA
rtol 1e-3 / atol 1e-5; each parameter's 3-step update (lr 1e-3) to 2% of
its norm; predictions and top-1/top-5 exactly; files exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt import precompute as jax_pre
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import swin_ucf101_preset as jax_preset
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils import checkpoint as jax_ckpt
from vitta_tpu_torch.adapt import precompute as pre
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models import swin as swin_mod
from vitta_tpu_torch.models.layers import flatten_taps
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.ops.dispatch import mlp_ln_fused
from vitta_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

K = 6
DEPTHS = (2, 2, 2, 1)
EMBED = 48
HEADS = (3, 6, 12, 24)
WINDOW = (2, 3, 3)
PATCH = (2, 4, 4)
T, HW, V = 4, 48, 2
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
LR = 1e-3
RTOL, ATOL = 1e-3, 1e-5
N_STEPS = 3
ROUTES = ("packed", "heads")
ARCH = "videoswintransformer"


def _cfg(preset):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0, **MODEL_KW),
        optim=dataclasses.replace(cfg.optim, lr=LR))


@pytest.fixture(scope="module")
def weights():
    """(reference-keyed state dict, JAX variables, source statistics)."""
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(K, PATCH, EMBED, DEPTHS, HEADS, WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = jax_ckpt.convert_swin_checkpoint(sd, K, depths=DEPTHS,
                                                 window_size=WINDOW)
    clean = np.random.default_rng(100).normal(
        size=(V, T, HW, HW, 3)).astype(np.float32)
    _, aux = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"]).items()}
    return sd, variables, src


def _port_model(sd, route):
    model = Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                         attn_route=route, **MODEL_KW)
    model.load_state_dict(sd, strict=True)
    return model


def _clip(seed, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, T, HW, HW, 3)).astype(np.float32)


def _videos(n=N_STEPS):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(n)]


# ------------------------------------------------------------- model level
def test_the_widths_lie_on_both_sides_of_the_mlp_rule():
    widths = [EMBED * 2 ** i for i in range(4)]
    assert [mlp_ln_fused(c, 16) for c in widths] == [False, False, False, True]
    # Swin-T and Swin-B at full size, 2 clips of 16 x 224 x 224
    tokens = [2 * 8 * (56 >> i) ** 2 for i in range(4)]
    assert [mlp_ln_fused(96 << i, n) for i, n in enumerate(tokens)] == [
        False, False, True, True]
    assert all(mlp_ln_fused(128 << i, n) for i, n in enumerate(tokens))
    assert not mlp_ln_fused(128, 12)      # whole groups of 8 tokens only


@pytest.mark.parametrize("route", ROUTES)
def test_which_ops_the_blocks_take(weights, route, monkeypatch):
    sd, _variables, _src = weights
    calls = dict.fromkeys(("mlp", "ln_mlp", "window_attention_packed",
                           "window_attention_heads", "attention_reference"), 0)
    for name in calls:
        def counted(*a, _fn=getattr(swin_mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(swin_mod, name, counted)
    with torch.no_grad():
        _port_model(sd, route)(torch.from_numpy(_clip(2)))
    # six blocks of full windows in stages 1 to 3, one clamped in stage 4
    full = {"packed": "window_attention_packed",
            "heads": "window_attention_heads"}
    want = dict.fromkeys(calls, 0)
    want.update({"mlp": 6, "ln_mlp": 1, full[route]: 6,
                 "attention_reference": 1})
    assert calls == want


@pytest.mark.parametrize("route", ROUTES)
def test_logits_and_taps_match_jax(weights, route):
    sd, variables, _src = weights
    x = _clip(1)
    want, aux = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(x), train=False, mutable=["taps"])
    taps = {}
    with torch.no_grad():
        got = _port_model(sd, route)(torch.from_numpy(x), taps)
    assert got.shape == (2, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)
    for leaf in ("stat", "stat_in"):
        want_l = jax_flatten_taps(aux["taps"], leaf)
        got_l = flatten_taps(taps, leaf)
        assert set(got_l) == set(want_l)
        assert set(got_l) == {n for n, _ in ckpt.swin_norm_layers(DEPTHS)}
        for name, s in got_l.items():
            for kind, a, b in (("mean", s.mean, want_l[name].mean),
                               ("var", s.var, want_l[name].var)):
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                    err_msg=f"{leaf} {kind} {name}")
    assert all(v["stat_n"] == 2.0 for v in taps.values())


def test_state_dict_round_trips_through_jax(weights):
    sd, variables, _src = weights
    back = ckpt.swin_state_dict_from_jax(variables, depths=DEPTHS,
                                         window_size=WINDOW)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    for route in ROUTES:
        model = Recognizer3D(attn_route=route, **MODEL_KW)
        assert set(model.state_dict()) == set(back)
        model.load_state_dict(back, strict=True)
    again = jax_ckpt.convert_swin_checkpoint(back, K, depths=DEPTHS,
                                             window_size=WINDOW)
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(again["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


def test_norm_layers_at_these_depths_and_at_swin_t():
    for depths in (DEPTHS, (2, 2, 6, 2)):
        assert ckpt.swin_norm_layers(depths) == jax_ckpt.swin_norm_layers(
            depths)
        # two per block, one per PatchMerging, the final one
        assert len(ckpt.swin_norm_layers(depths)) == 2 * sum(depths) + 4


# ------------------------------------------------------------ engine level
@pytest.fixture(scope="module")
def jax_run(weights):
    """The JAX engine's eval outputs and its 3-step trajectory, made once:
    the reference of both routes."""
    _sd, variables, src = weights
    jmodel = JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0, **MODEL_KW)
    jeng = JaxEngine(jmodel, _cfg(jax_preset), variables, src, donate=False)
    evals = []
    rng = np.random.default_rng(11)
    for i in range(2):
        clip = rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8)
        label = np.asarray([i % K], np.int32)
        t1, t5, pred = jeng.eval_step(jeng.init_params, jnp.asarray(clip),
                                      jnp.asarray(label))
        evals.append((clip, label, float(t1), float(t5),
                      np.asarray(pred).tolist(), np.asarray(
                          jeng._apply_eval(jeng.init_params,
                                           jnp.asarray(clip)))))
    state = jeng.init_state()
    key = jax.random.PRNGKey(0)
    steps = []
    for i, (views, clip, label) in enumerate(_videos()):
        state, m = jeng.adapt_eval_step(state, jnp.asarray(views),
                                        jnp.asarray(clip), jnp.asarray(label),
                                        jax.random.fold_in(key, i))
        params = ckpt.swin_state_dict_from_jax(
            {"params": state.params}, depths=DEPTHS, window_size=WINDOW)
        steps.append(dict(
            losses={f: float(getattr(m, f))
                    for f in ("loss_reg", "loss_consis", "loss_ce")},
            top=(float(m.top1), float(m.top5)),
            pred=np.asarray(m.pred).tolist(),
            logits=np.asarray(jeng._apply_eval(state.params,
                                               jnp.asarray(clip))),
            ema={k: tuple(np.asarray(a) for a in s)
                 for k, s in state.ema.items()},
            params={k: v.numpy() for k, v in params.items()}))
    return tuple(jeng.tap_names), evals, steps


def _port_engine(weights, route):
    sd, _variables, src = weights
    cfg = _cfg(swin_ucf101_preset)
    model = get_model(cfg, attn_route=route)
    model.cls_head.dropout = 0.0
    return VittaEngine(model, cfg, sd, src, device="cpu")


@pytest.mark.parametrize("route", ROUTES)
def test_eval_step_matches_jax(weights, jax_run, route):
    tap_names, evals, _steps = jax_run
    eng = _port_engine(weights, route)
    assert eng.tap_names == tap_names and eng.tap_names
    for clip, label, jt1, jt5, jpred, jlogits in evals:
        t1, t5, pred = eng.eval_step(eng.init_params, clip, label)
        assert (float(t1), float(t5)) == (jt1, jt5)
        assert pred.tolist() == jpred
        np.testing.assert_allclose(eng.eval_logits(clip).numpy(), jlogits,
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_source_statistics_and_their_files_match_jax(weights, route,
                                                     tmp_path):
    sd, variables, _src = weights
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(b, T, HW, HW, 3)).astype(np.float32),
                np.zeros(b, np.int64)) for b in (2, 1)]
    want = jax_pre.compute_source_statistics(
        JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW), variables, batches)
    got = pre.compute_source_statistics(_port_model(sd, route), batches,
                                        device="cpu")
    assert set(got) == set(want) == {
        n for n, _ in ckpt.swin_norm_layers(DEPTHS)}
    for name, (m, v) in got.items():
        np.testing.assert_allclose(m, want[name][0], rtol=RTOL, atol=ATOL,
                                   err_msg=f"mean {name}")
        np.testing.assert_allclose(v, want[name][1], rtol=RTOL, atol=ATOL,
                                   err_msg=f"var {name}")
    # written and reloaded unchanged, and entry by entry what the JAX
    # package's writer puts on disk at these depths
    mean_p, var_p, npz_p = pre.save_source_statistics(
        got, ARCH, str(tmp_path / "port"), tag="t", depths=DEPTHS)
    jmean, jvar = str(tmp_path / "jm.npy"), str(tmp_path / "jv.npy")
    jax_ckpt.save_stats(jmean, jvar, got, ARCH, depths=DEPTHS)
    for ours, theirs in ((mean_p, jmean), (var_p, jvar)):
        a = list(np.load(ours, allow_pickle=True))
        b = list(np.load(theirs, allow_pickle=True))
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for loaded in (ckpt.load_reference_stats(mean_p, var_p, ARCH,
                                             depths=DEPTHS),
                   pre.load_source_statistics_npz(npz_p),
                   jax_pre.load_source_statistics_npz(npz_p)):
        assert set(loaded) == set(got)
        for name, (m, v) in got.items():
            np.testing.assert_array_equal(loaded[name][0], m, err_msg=name)
            np.testing.assert_array_equal(loaded[name][1], v, err_msg=name)


def _port_trajectory(weights, route):
    eng = _port_engine(weights, route)
    state = eng.init_state()
    steps = []
    for views, clip, label in _videos():
        state, m = eng.adapt_eval_step(state, views, clip, label)
        steps.append(dict(
            losses={f: float(getattr(m, f))
                    for f in ("loss_reg", "loss_consis", "loss_ce")},
            top=(float(m.top1), float(m.top5)), pred=m.pred.tolist(),
            logits=eng.eval_logits(clip).numpy(),
            ema={k: (s.mean.numpy().copy(), s.var.numpy().copy())
                 for k, s in state.ema.items()},
            params={k: p.detach().numpy().copy()
                    for k, p in eng.model.named_parameters()}))
    assert state.step == N_STEPS
    return steps


@pytest.fixture(scope="module")
def port_runs(weights):
    """The port's 3-step trajectory under each route, made once."""
    return {route: _port_trajectory(weights, route) for route in ROUTES}


def _assert_steps_close(got_steps, want_steps, init, what):
    for i, (got, want) in enumerate(zip(got_steps, want_steps)):
        for field, value in got["losses"].items():
            np.testing.assert_allclose(value, want["losses"][field],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {field} step {i}")
        assert got["top"] == want["top"] and got["pred"] == want["pred"]
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=2e-3,
                                   atol=2e-4,
                                   err_msg=f"{what} eval logits step {i}")
        assert set(got["ema"]) == set(want["ema"]) and got["ema"]
        for name, stats in got["ema"].items():
            for g, w in zip(stats, want["ema"][name]):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} ema {name}")
        # every parameter, as its update from the common initial weights
        assert set(got["params"]) <= set(want["params"])
        moved = 0
        for k, p in got["params"].items():
            dw = want["params"][k] - init[k].numpy()
            dp = p - init[k].numpy()
            assert np.linalg.norm(dp - dw) <= (
                2e-2 * np.linalg.norm(dw) + 1e-8), f"{what} {k} step {i}"
            moved += np.linalg.norm(dw) > 0
        # the relative-position tables included: the bias gradient is used
        assert moved == len(got["params"])


@pytest.mark.parametrize("route", ROUTES)
def test_trajectory_matches_jax(weights, jax_run, port_runs, route):
    _tap_names, _evals, jsteps = jax_run
    _assert_steps_close(port_runs[route], jsteps, weights[0], route)


def test_heads_and_packed_agree(weights, port_runs):
    _assert_steps_close(port_runs["heads"], port_runs["packed"], weights[0],
                        "heads against packed")
