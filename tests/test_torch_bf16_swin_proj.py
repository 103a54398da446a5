"""Video Swin at bfloat16 under the projection-fused routes (PERF.md rows
16-19 at bfloat16: ``attn_route="proj"`` and ``"ln_proj"``) through the port
as a whole, on the CPU, against vitta_tpu's ``Recognizer3D(dtype=
"bfloat16")`` under ``VITTA_ATTN_PROJ_FUSED=1`` / ``VITTA_ATTN_LN=1``.

Two models: tests/test_torch_bf16_swin.py's (``"b"``: embed 128, depths
(2, 1), heads (4, 8), every width a multiple of 128, so norm2 runs inside
the LayerNorm-MLP op as at Swin-B's widths) and tests/test_torch_bf16_swin_t
.py's (``"t"``: embed 48, depths (2, 2, 2, 1), Swin-T's heads (3, 6, 12,
24), head dim 16, widths on both sides of the norm2 rule, and a clamped
block in stage 4 that takes the plain attention), window (2, 3, 3), clips
of 4 x 48 x 48.  Weights come from tests/torch_swin.py's oracle through
``convert_swin_checkpoint``; drop-path and dropout are off.  On the CPU
vitta_tpu's projection-fused routes are its jnp composition (one
LayerNorm, the bfloat16 Dense, the packed attention), the same math under
either flag; ``test_logits_and_taps_match_jax_bf16`` asserts that its two
forwards agree bit for bit, and one vitta_tpu trajectory (both flags set)
is the reference of both of the port's routes.

Tolerances, and why: those of tests/test_torch_bf16_swin.py (the forward)
and tests/test_torch_bf16_swin_engine.py (the trajectories), whose reasons
hold here.  vitta_tpu's forward runs op by op (``apply`` outside ``jit``),
since XLA:CPU drops bfloat16 roundings inside a compiled program; each tap
statistic and the logits are held to ``BF16_FACTOR`` (3) times the move
bfloat16 makes in vitta_tpu's own forward against its float32 one.  The
3-step trajectories (``VittaEngine`` with the twin of the cast weights on,
vitta_tpu's ``params_half``; the taps of the second stage and of the final
norm; lr 1e-3): reg and ce losses rtol 1e-3, predictions and top-1 / top-5
exactly; each EMA layer's mean within 1e-2 of its largest magnitude, its
variance at rtol 2e-2 / atol 1e-2 of the layer's largest v + m^2; the
whole update within 5% of its norm, the median tensor's within 2%, every
tensor's within 75%, and every tensor vitta_tpu moves moved by the port.
The consistency loss: atol 2e-4 on model ``"b"`` (that of
tests/test_torch_bf16_swin_engine.py, the same model), and on model
``"t"`` tests/test_torch_bf16_swin_t.py's rule for its deeper logits:
``BF16_FACTOR`` times the largest move bfloat16 makes of it in vitta_tpu's
own 3 steps against its float32 ones, never tighter than 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_swin import BF16_FACTOR, _assert_near
from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import swin_ucf101_preset as jax_preset
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models import swin as swin_mod
from vitta_tpu_torch.models.layers import flatten_taps
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.utils.checkpoint import (swin_norm_layers,
                                              swin_state_dict_from_jax)

torch.set_num_threads(1)

K = 5
PATCH, WINDOW = (2, 4, 4), (2, 3, 3)
T, HW, V = 4, 48, 2
MODELS = {"b": dict(embed_dim=128, depths=(2, 1), num_heads=(4, 8)),
          "t": dict(embed_dim=48, depths=(2, 2, 2, 1),
                    num_heads=(3, 6, 12, 24))}
ROUTES = ("proj", "ln_proj")
# vitta_tpu's flags for each route (its ln_proj falls back to proj)
FLAGS = {"proj": {"VITTA_ATTN_PROJ_FUSED": "1"},
         "ln_proj": {"VITTA_ATTN_PROJ_FUSED": "1", "VITTA_ATTN_LN": "1"}}
ALL_FLAGS = ("VITTA_ATTN_PROJ_FUSED", "VITTA_ATTN_LN", "VITTA_ATTN_NO_PROJ")
CHOSEN = ("layers.1", "backbone.norm")
LR = 1e-3
N_STEPS = 3
WHOLE, MEDIAN, EACH = 5e-2, 2e-2, 0.75
CONSIS_ATOL = 2e-4


def _kw(model):
    return dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                **MODELS[model])


def _set_flags(mp, route):
    for var in ALL_FLAGS:
        mp.delenv(var, raising=False)
    for var, value in FLAGS.get(route, {}).items():
        mp.setenv(var, value)


def _jax_forward(variables, model, dtype, x, route=None):
    """(logits, {tap name: (mean, var)}) of vitta_tpu's Swin at ``dtype``
    under ``route``'s flags, run op by op."""
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, route)
        jm = JaxRecognizer3D(drop_path_rate=0.0, dtype=dtype, **_kw(model))
        logits, aux = jm.apply(variables, jnp.asarray(x), train=False,
                               mutable=["taps"])
    taps = {n: (np.asarray(s.mean), np.asarray(s.var))
            for n, s in jax_flatten_taps(aux["taps"], "stat").items()}
    return np.asarray(logits), taps


@pytest.fixture(scope="module")
def shared():
    """Per model: the weights (reference-keyed and as vitta_tpu's
    variables), the float32 source statistics, a clip and vitta_tpu's
    float32 forward of it."""
    out = {}
    for model, mk in MODELS.items():
        torch.manual_seed(0)
        oracle = TorchRecognizer3D(K, PATCH, mk["embed_dim"], mk["depths"],
                                   mk["num_heads"], WINDOW)
        with torch.no_grad():
            for m in oracle.modules():
                if hasattr(m, "relative_position_bias_table"):
                    m.relative_position_bias_table.normal_(0, 0.5)
        sd = {k: v.clone() for k, v in oracle.state_dict().items()}
        variables = convert_swin_checkpoint(sd, K, depths=mk["depths"],
                                            window_size=WINDOW)
        x = np.random.default_rng(0).normal(size=(2, T, HW, HW, 3)).astype(
            np.float32)
        clean = np.random.default_rng(100).normal(
            size=(V, T, HW, HW, 3)).astype(np.float32)
        _, aux = JaxRecognizer3D(drop_path_rate=0.0, **_kw(model)).apply(
            variables, jnp.asarray(clean), train=False, mutable=["taps"])
        src = {n: (np.asarray(s.mean), np.asarray(s.var))
               for n, s in jax_flatten_taps(aux["taps"]).items()}
        out[model] = dict(sd=sd, variables=variables, x=x, src=src,
                          jax32=_jax_forward(variables, model, "float32", x))
    return out


def _port(sd, model, route):
    m = Recognizer3D(drop_path_rate=0.0, head_dropout=0.0, dtype="bfloat16",
                     attn_route=route, **_kw(model))
    m.load_state_dict(sd, strict=True)
    return m.eval()


# ------------------------------------------------------------- model level
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("model", MODELS)
def test_which_ops_the_bf16_blocks_take(shared, model, route, monkeypatch):
    """Every block of full windows takes the route's bfloat16 op (no packed
    attention, no F.linear projection): ``"b"`` 3 blocks; ``"t"`` 6, and
    its clamped stage-4 block the plain attention at float32.  The op gets
    the dense bias (nh, N, N) and the projections' weights and biases at
    bfloat16."""
    op = {"proj": "window_attention_proj",
          "ln_proj": "window_attention_ln_proj"}[route]
    calls = {}
    for name in (op, "window_attention_packed", "window_attention_heads",
                 "attention_reference"):
        def counted(*a, _fn=getattr(swin_mod, name), _name=name, **kw):
            calls.setdefault(_name, []).append(a[0].dtype)
            if _name == op:
                at = 3 if route == "proj" else 6
                calls.setdefault("weights", []).extend(
                    t.dtype for t in a[at - 2:at + 2])
                calls.setdefault("bias", []).append(
                    (a[at + 2].dim(), a[at + 2].dtype))
            return _fn(*a, **kw)
        monkeypatch.setattr(swin_mod, name, counted)
    with torch.no_grad():
        _port(shared[model]["sd"], model, route)(
            torch.from_numpy(shared[model]["x"]))
    blocks = {"b": 3, "t": 6}[model]
    want = {op: [torch.bfloat16] * blocks,
            "weights": [torch.bfloat16] * 4 * blocks,
            "bias": [(3, torch.float32)] * blocks}
    if model == "t":
        want["attention_reference"] = [torch.float32]
    assert calls == want


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("model", MODELS)
def test_logits_and_taps_match_jax_bf16(shared, model, route):
    s = shared[model]
    l16, t16 = _jax_forward(s["variables"], model, "bfloat16", s["x"],
                            route)
    # on the CPU vitta_tpu's routes are one jnp math: its packed forward
    # gives the same bits
    lp, tp = _jax_forward(s["variables"], model, "bfloat16", s["x"])
    np.testing.assert_array_equal(l16, lp)
    m = _port(s["sd"], model, route)
    taps = {}
    with torch.no_grad():
        logits = m(torch.from_numpy(s["x"]), taps)
    l32, t32 = s["jax32"]
    assert logits.dtype == torch.float32 and logits.shape == (2, K)
    _assert_near(logits.numpy(), l16, l32, "logits")
    got = flatten_taps(taps, "stat")
    assert set(got) == set(t16) == {n for n, _ in swin_norm_layers(
        MODELS[model]["depths"])}
    for name, stats in got.items():
        for i, part in enumerate(stats):
            assert part.dtype == torch.float32, name
            np.testing.assert_array_equal(tp[name][i], t16[name][i])
            _assert_near(part.numpy(), t16[name][i], t32[name][i],
                         f"{name}[{i}]")


# ------------------------------------------------------------ engine level
def _cfg(preset, model):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0,
                                  **_kw(model)),
        optim=dataclasses.replace(cfg.optim, lr=LR),
        tta=dataclasses.replace(cfg.tta, chosen_blocks=CHOSEN))


def _videos():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(N_STEPS)]


def _jax_trajectory(s, model, dtype):
    """(engine, metrics, final state) of vitta_tpu's engine at ``dtype``
    under both flags over the videos."""
    with pytest.MonkeyPatch.context() as mp:
        _set_flags(mp, "ln_proj")
        jeng = JaxEngine(JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                         dtype=dtype, **_kw(model)),
                         _cfg(jax_preset, model), s["variables"], s["src"],
                         donate=False)
        state, key, metrics = jeng.init_state(), jax.random.PRNGKey(0), []
        for i, (views, clip, label) in enumerate(_videos()):
            state, m = jeng.adapt_eval_step(
                state, jnp.asarray(views), jnp.asarray(clip),
                jnp.asarray(label), jax.random.fold_in(key, i))
            metrics.append(m)
    return jeng, metrics, state


@pytest.fixture(scope="module")
def jax_runs(shared):
    """Per model: vitta_tpu's engine at bfloat16 with its twin of the cast
    weights, the reference of both routes (metrics, EMA, final weights),
    and the consistency loss's bound."""
    runs = {}
    for model in MODELS:
        s = shared[model]
        jeng, metrics, state = _jax_trajectory(s, model, "bfloat16")
        assert jeng._half
        tol = CONSIS_ATOL
        if model == "t":
            _e, metrics32, _s = _jax_trajectory(s, model, "float32")
            tol = max(tol, BF16_FACTOR * max(
                abs(float(m.loss_consis) - float(m32.loss_consis))
                for m, m32 in zip(metrics, metrics32)))
        want = swin_state_dict_from_jax(
            {"params": state.params}, depths=MODELS[model]["depths"],
            window_size=WINDOW)
        runs[model] = (tuple(jeng.tap_names), metrics, state.ema, want, tol)
    return runs


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("model", MODELS)
def test_trajectory_matches_jax_bf16(shared, jax_runs, model, route):
    tap_names, jmetrics, jema, want, consis_tol = jax_runs[model]
    s = shared[model]
    sd = s["sd"]
    eng = VittaEngine(Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                   dtype="bfloat16", attn_route=route,
                                   **_kw(model)),
                      _cfg(swin_ucf101_preset, model), sd, s["src"],
                      device="cpu")
    assert eng._twin is not None and eng.model.dtype == torch.bfloat16
    assert eng.tap_names == tap_names and tap_names
    state = eng.init_state()
    for i, ((views, clip, label), jm) in enumerate(zip(_videos(), jmetrics)):
        state, m = eng.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_ce"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jm, field)), rtol=1e-3,
                                       err_msg=f"{route} {field} step {i}")
        np.testing.assert_allclose(float(m.loss_consis),
                                   float(jm.loss_consis), rtol=0,
                                   atol=consis_tol,
                                   err_msg=f"{route} loss_consis step {i}")
        for field in ("top1", "top5"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
    assert state.step == N_STEPS
    assert set(state.ema) == set(jema) and state.ema
    for name, (gm, gv) in state.ema.items():
        assert gm.dtype == gv.dtype == torch.float32
        wm, wv = (np.asarray(v) for v in jema[name])
        np.testing.assert_allclose(gm.numpy(), wm, rtol=0,
                                   atol=1e-2 * float(np.abs(wm).max()),
                                   err_msg=f"{route} ema {name}")
        second = float((np.abs(wv) + wm ** 2).max())   # E[y^2]'s size
        np.testing.assert_allclose(gv.numpy(), wv, rtol=2e-2,
                                   atol=1e-2 * second,
                                   err_msg=f"{route} ema var {name}")
    got = eng.model.state_dict()
    diffs, norms, each = [], [], []
    for k, w in want.items():
        if k.endswith("relative_position_index"):
            continue
        assert got[k].dtype == torch.float32, k
        init = sd[k].numpy().astype(np.float64)
        dj, dp = w.numpy() - init, got[k].numpy() - init
        diff, norm = np.linalg.norm(dp - dj), np.linalg.norm(dj)
        diffs.append(diff)
        norms.append(norm)
        if norm > 0:
            assert np.linalg.norm(dp) > 0, f"{route} {k}: not moved"
            assert diff <= EACH * norm, f"{route} {k}: {diff / norm:.3f}"
            each.append(diff / norm)
        else:
            assert diff == 0, k
    whole = np.linalg.norm(diffs) / np.linalg.norm(norms)
    assert whole <= WHOLE, f"{route}: the whole update {whole:.4f}"
    assert np.median(each) <= MEDIAN, np.median(each)
