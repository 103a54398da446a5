"""The projection-fused attention routes of the port's Video Swin as a
whole, on the CPU, against the JAX package under the same flags and
against each other.

The tiny config of tests/test_torch_swin_engine.py (shifted, clamped and
padded windows; window (2, 3, 3), so hw = 9 is no multiple of 8; 1 to 8
heads; C = 8 to 64, no multiple of 128; four mask windows at the first
stage), at two input sizes: 24, where the blocks of the first two stages
pad nothing and take the ops of vitta_tpu_torch/ops/cuda_attention_proj.py,
and 28, where they pad (7 tokens per side for a window of 3) and
``"ln_proj"`` must fall back.  The port runs with ``attn_route="proj"`` /
``"ln_proj"``; the JAX ``VittaEngine`` and model run under
``VITTA_ATTN_PROJ_FUSED=1`` / ``VITTA_ATTN_LN=1``, set before they are
built, which takes the fused branch of vitta_tpu/models/swin.py:376-384
with the op's composition path.  Weights cross through
``swin_state_dict_from_jax`` / ``convert_swin_checkpoint``; drop-path and
dropout are off, so no random numbers enter.

Tolerances are those of tests/test_torch_swin.py and
tests/test_torch_swin_engine.py, for the same reasons (float32 products
summed in different orders through the blocks): logits rtol 2e-3 / atol
2e-4; tap and source statistics rtol 1e-3 / atol 1e-5; losses and the EMA
rtol 1e-3 / atol 1e-5; each parameter's 3-step update (lr 1e-3) to 2% of
its norm; predictions and top-1/top-5 exactly.  The port's three routes
are held to each other at the same bounds.
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
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt import precompute as pre
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models import swin as swin_mod
from vitta_tpu_torch.models.layers import flatten_taps
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.utils.checkpoint import swin_state_dict_from_jax

torch.set_num_threads(1)

K = 6
DEPTHS = (1, 1, 2, 1)
EMBED = 8
HEADS = (1, 2, 4, 8)
WINDOW = (2, 3, 3)
PATCH = (2, 4, 4)
T, V = 4, 2
HW_FULL, HW_PAD = 24, 28
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
LR = 1e-3
RTOL, ATOL = 1e-3, 1e-5
N_STEPS = 3
ROUTES = ("proj", "ln_proj")
FLAG = {"proj": "VITTA_ATTN_PROJ_FUSED", "ln_proj": "VITTA_ATTN_LN"}
ALL_FLAGS = ("VITTA_ATTN_PROJ_FUSED", "VITTA_ATTN_LN", "VITTA_ATTN_NO_PROJ")


def _cfg(preset, hw=HW_FULL):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=hw,
                                 scale_size=hw),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0, **MODEL_KW),
        optim=dataclasses.replace(cfg.optim, lr=LR))


def _set_route(monkeypatch, route):
    """The JAX package's flags for ``route``; the port gets the argument."""
    for var in ALL_FLAGS:
        monkeypatch.delenv(var, raising=False)
    if route in FLAG:
        monkeypatch.setenv(FLAG[route], "1")


@pytest.fixture(scope="module")
def weights():
    """(reference-keyed state dict, JAX variables, {hw: source statistics})."""
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(K, PATCH, EMBED, DEPTHS, HEADS, WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, K, depths=DEPTHS,
                                        window_size=WINDOW)
    src = {}
    for hw in (HW_FULL, HW_PAD):
        clean = np.random.default_rng(100).normal(
            size=(V, T, hw, hw, 3)).astype(np.float32)
        _, aux = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
            variables, jnp.asarray(clean), train=False, mutable=["taps"])
        src[hw] = {n: (np.asarray(s.mean), np.asarray(s.var))
                   for n, s in jax_flatten_taps(aux["taps"]).items()}
    return sd, variables, src


def _port_model(sd, route, **kw):
    model = Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                         attn_route=route, **MODEL_KW, **kw)
    model.load_state_dict(sd, strict=True)
    return model


def _clip(seed, hw, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, T, hw, hw, 3)).astype(np.float32)


def _videos(hw, n=N_STEPS):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, hw, hw, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, hw, hw, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(n)]


def _count_ops(monkeypatch):
    """Count the calls of the three attention ops the model makes."""
    calls = dict.fromkeys(("packed", "proj", "ln_proj"), 0)
    for route, name in (("packed", "window_attention_packed"),
                        ("proj", "window_attention_proj"),
                        ("ln_proj", "window_attention_ln_proj")):
        def counted(*a, _fn=getattr(swin_mod, name), _route=route, **kw):
            calls[_route] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(swin_mod, name, counted)
    return calls


# ------------------------------------------------------------- model level
@pytest.mark.parametrize("hw", [HW_FULL, HW_PAD])
@pytest.mark.parametrize("route", ROUTES)
def test_logits_and_taps_match_jax(weights, route, hw, monkeypatch):
    sd, variables, _src = weights
    _set_route(monkeypatch, route)
    x = _clip(1, hw)
    want, aux = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(x), train=False, mutable=["taps"])
    taps = {}
    with torch.no_grad():
        got = _port_model(sd, route)(torch.from_numpy(x), taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)
    for leaf in ("stat", "stat_in"):
        want_l = jax_flatten_taps(aux["taps"], leaf)
        got_l = flatten_taps(taps, leaf)
        assert set(got_l) == set(want_l) and got_l
        for name, s in got_l.items():
            for kind, a, b in (("mean", s.mean, want_l[name].mean),
                               ("var", s.var, want_l[name].var)):
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL,
                    err_msg=f"{leaf} {kind} {name}")
    # the statistics count samples, not windows
    assert all(v["stat_n"] == 2.0 for v in taps.values())


@pytest.mark.parametrize("hw,want", [
    # stages 1 and 2 hold full windows: one block each; stages 3 and 4 are
    # clamped and keep the plain attention on every route
    (HW_FULL, {"packed": (2, 0, 0), "proj": (0, 2, 0), "ln_proj": (0, 0, 2)}),
    # 7 tokens per side pad to 9: an explicit "ln_proj" falls back to "proj"
    (HW_PAD, {"packed": (2, 0, 0), "proj": (0, 2, 0), "ln_proj": (0, 2, 0)}),
])
def test_which_op_a_block_takes(weights, hw, want, monkeypatch):
    sd, _variables, _src = weights
    _set_route(monkeypatch, None)
    calls = _count_ops(monkeypatch)
    for route, (packed, proj, ln_proj) in want.items():
        for k in calls:
            calls[k] = 0
        with torch.no_grad():
            _port_model(sd, route)(torch.from_numpy(_clip(2, hw)))
        assert calls == {"packed": packed, "proj": proj, "ln_proj": ln_proj}, \
            route


def test_padded_fallback_follows_the_proj_flag(weights, monkeypatch):
    """Under ``attn_route=None`` the flags name the fallback; an explicit
    ``"ln_proj"`` does not read them."""
    sd, _variables, _src = weights
    x = torch.from_numpy(_clip(2, HW_PAD))
    calls = _count_ops(monkeypatch)
    for proj_flag, want in (("0", {"packed": 2, "proj": 0, "ln_proj": 0}),
                            ("1", {"packed": 0, "proj": 2, "ln_proj": 0})):
        _set_route(monkeypatch, "ln_proj")
        monkeypatch.setenv("VITTA_ATTN_PROJ_FUSED", proj_flag)
        for k in calls:
            calls[k] = 0
        with torch.no_grad():
            _port_model(sd, None)(x)
        assert calls == want, proj_flag
    monkeypatch.setenv("VITTA_ATTN_NO_PROJ", "1")
    for k in calls:
        calls[k] = 0
    with torch.no_grad():
        _port_model(sd, "ln_proj")(x)
    assert calls == {"packed": 0, "proj": 2, "ln_proj": 0}


def test_one_converted_tree_serves_three_routes(weights):
    _sd, variables, _src = weights
    converted = swin_state_dict_from_jax(variables, depths=DEPTHS,
                                         window_size=WINDOW)
    x = torch.from_numpy(_clip(3, HW_FULL))
    outs, taps = {}, {}
    for route in ("packed",) + ROUTES:
        model = Recognizer3D(drop_path_rate=0.0, attn_route=route, **MODEL_KW)
        assert set(model.state_dict()) == set(converted)
        model.load_state_dict(converted, strict=True)
        taps[route] = {}
        with torch.no_grad():
            outs[route] = model(x, taps[route])
    for route in ROUTES:
        torch.testing.assert_close(outs[route], outs["packed"], rtol=2e-3,
                                   atol=2e-4)
        assert list(taps[route]) == list(taps["packed"])
        for name, leaves in taps["packed"].items():
            assert set(taps[route][name]) == set(leaves)
            for leaf in ("stat", "stat_in"):
                for a, b in zip(taps[route][name][leaf], leaves[leaf]):
                    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ engine level
def _jax_engine(weights, hw):
    _sd, variables, src = weights
    jmodel = JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0, **MODEL_KW)
    return JaxEngine(jmodel, _cfg(jax_preset, hw), variables, src[hw],
                     donate=False)


def _port_engine(weights, route, hw):
    sd, _variables, src = weights
    cfg = _cfg(swin_ucf101_preset, hw)
    model = get_model(cfg, attn_route=route)
    model.cls_head.dropout = 0.0
    return VittaEngine(model, cfg, sd, src[hw], device="cpu")


@pytest.mark.parametrize("route", ROUTES)
def test_eval_step_and_source_statistics_match_jax(weights, route,
                                                   monkeypatch):
    sd, variables, _src = weights
    _set_route(monkeypatch, route)
    jeng = _jax_engine(weights, HW_FULL)
    eng = _port_engine(weights, route, HW_FULL)
    assert eng.tap_names == tuple(jeng.tap_names) and eng.tap_names
    rng = np.random.default_rng(11)
    for i in range(2):
        clip = rng.integers(0, 256, (1, T, HW_FULL, HW_FULL, 3),
                            dtype=np.uint8)
        label = np.asarray([i % K], np.int32)
        jt1, jt5, jpred = jeng.eval_step(jeng.init_params, jnp.asarray(clip),
                                         jnp.asarray(label))
        t1, t5, pred = eng.eval_step(eng.init_params, clip, label)
        assert float(t1) == float(jt1) and float(t5) == float(jt5)
        assert pred.tolist() == np.asarray(jpred).tolist()
        np.testing.assert_allclose(
            eng.eval_logits(clip).numpy(),
            np.asarray(jeng._apply_eval(jeng.init_params, jnp.asarray(clip))),
            rtol=2e-3, atol=2e-4)
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(b, T, HW_FULL, HW_FULL, 3)).astype(
        np.float32), np.zeros(b, np.int64)) for b in (2, 1)]
    want = jax_pre.compute_source_statistics(
        JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW), variables, batches)
    got = pre.compute_source_statistics(_port_model(sd, route), batches,
                                        device="cpu")
    assert set(got) == set(want) and got
    for name, (m, v) in got.items():
        np.testing.assert_allclose(m, want[name][0], rtol=RTOL, atol=ATOL,
                                   err_msg=f"mean {name}")
        np.testing.assert_allclose(v, want[name][1], rtol=RTOL, atol=ATOL,
                                   err_msg=f"var {name}")


def _port_trajectory(weights, route, hw):
    eng = _port_engine(weights, route, hw)
    state = eng.init_state()
    steps = []
    for views, clip, label in _videos(hw):
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
    return eng, steps


def _assert_updates_close(got, want, init, what):
    """Every parameter, as its update from the common initial weights."""
    assert set(got) <= set(want)
    moved = 0
    for k, p in got.items():
        dj, dp = want[k] - init[k].numpy(), p - init[k].numpy()
        assert np.linalg.norm(dp - dj) <= 2e-2 * np.linalg.norm(dj) + 1e-8, (
            f"{k} {what}")
        moved += np.linalg.norm(dj) > 0
    # the relative-position tables included: the bias gradient is used
    assert moved == len(got)


@pytest.mark.parametrize("route,hw", [("proj", HW_FULL), ("ln_proj", HW_FULL),
                                      ("ln_proj", HW_PAD)])
def test_trajectory_matches_jax(weights, route, hw, monkeypatch):
    sd, _variables, _src = weights
    _set_route(monkeypatch, route)
    jeng = _jax_engine(weights, hw)
    eng, steps = _port_trajectory(weights, route, hw)
    assert eng.tap_names == tuple(jeng.tap_names)
    jstate = jeng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, ((views, clip, label), got) in enumerate(zip(_videos(hw), steps)):
        jstate, jm = jeng.adapt_eval_step(jstate, jnp.asarray(views),
                                          jnp.asarray(clip),
                                          jnp.asarray(label),
                                          jax.random.fold_in(rng, i))
        for field, value in got["losses"].items():
            np.testing.assert_allclose(value, float(getattr(jm, field)),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{field} step {i}")
        assert got["top"] == (float(jm.top1), float(jm.top5))
        assert got["pred"] == np.asarray(jm.pred).tolist()
        np.testing.assert_allclose(
            got["logits"],
            np.asarray(jeng._apply_eval(jstate.params, jnp.asarray(clip))),
            rtol=2e-3, atol=2e-4, err_msg=f"eval logits step {i}")
        assert set(got["ema"]) == set(jstate.ema) and got["ema"]
        for name, stats in got["ema"].items():
            for g, w in zip(stats, jstate.ema[name]):
                np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                           atol=ATOL, err_msg=f"ema {name}")
        want = swin_state_dict_from_jax({"params": jstate.params},
                                        depths=DEPTHS, window_size=WINDOW)
        _assert_updates_close(got["params"],
                              {k: v.numpy() for k, v in want.items()}, sd,
                              f"step {i}")


@pytest.mark.parametrize("hw", [HW_FULL, HW_PAD])
def test_the_three_routes_agree(weights, hw):
    sd, _variables, _src = weights
    runs = {route: _port_trajectory(weights, route, hw)[1]
            for route in ("packed",) + ROUTES}
    for route in ROUTES:
        for i, (got, want) in enumerate(zip(runs[route], runs["packed"])):
            for field, value in got["losses"].items():
                np.testing.assert_allclose(value, want["losses"][field],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{route} {field} step {i}")
            assert got["top"] == want["top"] and got["pred"] == want["pred"]
            np.testing.assert_allclose(got["logits"], want["logits"],
                                       rtol=2e-3, atol=2e-4)
            for name, stats in got["ema"].items():
                for g, w in zip(stats, want["ema"][name]):
                    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                               err_msg=f"{route} ema {name}")
            _assert_updates_close(got["params"], want["params"], sd,
                                  f"{route} step {i}")
