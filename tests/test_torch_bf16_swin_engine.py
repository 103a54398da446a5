"""3-step ViTTA trajectories of the port's engine on the bfloat16 Video Swin
against the JAX ``VittaEngine`` on vitta_tpu's ``Recognizer3D(dtype=
"bfloat16")``, with its sparse bfloat16 twin of the cast weights on
(``params_half``, vitta_tpu/adapt/engine.py:125-132, 267-276), from the same
float32 weights, source statistics and uint8 videos.  The model is
tests/test_torch_bf16_swin.py's (every width a multiple of 128, so norm2
runs inside the LayerNorm-MLP op as on Swin-B), 4 frames of 48 x 48, the
taps of its second stage and final norm, drop-path and dropout 0, lr 1e-3.
Both keep float32 masters and float32 SGD, and both a bfloat16 twin of the
cast weights: vitta_tpu's ``half_cast_flags`` (every Dense and Conv kernel
and bias of the backbone) and the port's ``HalfTwin`` (every nn.Linear and
nn.Conv3d of the backbone, models/swin.py), so both multiply by the same
bfloat16 weights.  ``test_half_twin_gives_the_bits_of_casting_at_use``
holds the port's twin to its casts at every use (``half_twin=False``): the
same rounding, so the same bits, exactly.

Tolerances, and why: those of tests/test_torch_bf16_engine.py (TANet at
bfloat16), whose reasons hold here: both engines round their activations
at their own points (the JAX engine, one compiled program, skips some of
them; the port rounds where its kernels round), and the sum-L1 consistency
loss's gradient is the sign of each logit difference between the two
views.  So:
* losses: reg and ce rtol 1e-3; consistency atol 2e-4 (an L1 sum of logit
  differences that bfloat16 moves by ~4e-4 a logit); predictions and
  top-1 / top-5 exactly;
* the EMA: each layer's mean within 1e-2 of its largest magnitude; its
  variance at rtol 2e-2 / atol 1e-2 of the layer's largest v + m^2 (a
  variance is E[y^2] - m^2 of bfloat16 values, and one ulp on every y
  moves E[y^2] by up to 2^-7 of it);
* parameters: the whole update within ``WHOLE`` (5%) of its norm, the
  median tensor's within 2%, every tensor's within ``EACH`` (75%) and
  every tensor that JAX moves moved by the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import swin_ucf101_preset as jax_preset
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.utils.checkpoint import swin_state_dict_from_jax

torch.set_num_threads(1)

K = 5
EMBED, DEPTHS, HEADS, WINDOW = 128, (2, 1), (4, 8), (2, 3, 3)
PATCH = (2, 4, 4)
T, HW, V = 4, 48, 2
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
CHOSEN = ("layers.1", "backbone.norm")
LR = 1e-3
N_STEPS = 3
WHOLE, MEDIAN, EACH = 5e-2, 2e-2, 0.75


def _cfg(preset):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0, **MODEL_KW),
        optim=dataclasses.replace(cfg.optim, lr=LR),
        tta=dataclasses.replace(cfg.tta, chosen_blocks=CHOSEN))


def _videos():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(N_STEPS)]


@pytest.fixture(scope="module")
def runs():
    """Both engines' metrics, EMA and final weights after N_STEPS."""
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(K, PATCH, EMBED, DEPTHS, HEADS, WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, K, depths=DEPTHS,
                                        window_size=WINDOW)
    # the source: one float32 tapped forward of a seeded clean clip
    clean = np.random.default_rng(100).normal(
        size=(V, T, HW, HW, 3)).astype(np.float32)
    _, aux = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"]).items()}
    jeng = JaxEngine(JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                     dtype="bfloat16", **MODEL_KW),
                     _cfg(jax_preset), variables, src, donate=False)
    eng = VittaEngine(Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                   dtype="bfloat16", **MODEL_KW),
                      _cfg(swin_ucf101_preset), sd, src, device="cpu")
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
    want = swin_state_dict_from_jax({"params": jstate.params}, depths=DEPTHS,
                                    window_size=WINDOW)
    return dict(sd=sd, src=src, eng=eng, jeng=jeng, state=state,
                jstate=jstate, metrics=metrics, want=want)


def test_engines_run_at_bf16_with_float32_masters(runs):
    eng, jeng = runs["eng"], runs["jeng"]
    assert jeng._half and runs["jstate"].params_half is not None
    assert eng.model.dtype == torch.bfloat16
    assert len(eng.tap_names) == 3            # layers_1: norm1, norm2; norm
    assert eng.tap_names == tuple(jeng.tap_names)
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
        if k.endswith("relative_position_index"):
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


def test_half_twin_gives_the_bits_of_casting_at_use(runs):
    """The engine's bfloat16 twin of the cast weights (on by default)
    against the model casting each weight where it uses it: the same
    losses, logits, EMA and updated float32 masters, bit for bit, over the
    3 steps; the twin holds every nn.Linear and nn.Conv3d parameter of the
    backbone, and after the last update the masters' bfloat16 values."""
    from vitta_tpu_torch.models.swin import half_cast_params
    eng = runs["eng"]
    assert eng._twin is not None
    model = eng.model
    linear = [p for m in model.backbone.modules()
              if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d))
              for p in m.parameters(recurse=False)]
    assert len(eng._twin.halves) == len(linear) == len(
        half_cast_params(model)) > 0
    for p, h in zip(eng._twin.masters, eng._twin.halves):
        assert h.dtype == torch.bfloat16 and torch.equal(h, p.detach().to(
            torch.bfloat16))
    cast = VittaEngine(Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                    dtype="bfloat16", **MODEL_KW),
                       _cfg(swin_ucf101_preset), runs["sd"], runs["src"],
                       device="cpu", half_twin=False)
    assert cast._twin is None
    state = cast.init_state()
    for (views, clip, label), (m, _jm) in zip(_videos(), runs["metrics"]):
        state, mc = cast.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_consis", "loss_ce", "pred"):
            assert torch.equal(getattr(mc, field), getattr(m, field)), field
    for k, p in cast.model.state_dict().items():
        assert torch.equal(p, model.state_dict()[k]), k
    for name, (gm, gv) in state.ema.items():
        want = runs["state"].ema[name]
        assert torch.equal(gm, want[0]) and torch.equal(gv, want[1]), name
