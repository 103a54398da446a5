"""The port's Video Swin at bfloat16 against vitta_tpu's
``Recognizer3D(dtype="bfloat16")`` on the CPU, through the same float32
weights (tests/torch_swin.py's oracle, as tests/test_torch_swin.py), the
routes it builds, and what it refuses.

The model: Swin-B's first width with every width a multiple of 128 (embed
128, depths (2, 1), heads (4, 8), window (2, 3, 3), 4 frames of 48 x 48), so
that norm2 runs inside the LayerNorm-MLP op as it does at every Swin-B width
(vitta_tpu/models/swin.py:428; vitta_tpu on the CPU runs it apart, with the
same rounding of y).

Tolerances, and why.  Both packages round 9 LayerNorms, 3 MLPs, 3
attentions and 4 dense products to bfloat16, each from float32 sums taken
in their own orders (oneDNN against XLA:CPU), and vitta_tpu on the CPU rounds
at points of its own (its plain MLP rounds h before the GELU, its attention
rounds the probabilities where its Pallas kernel rounds e); a value one
rounds up the other may round down, and the difference travels.
vitta_tpu's forward runs op by op here (``apply`` outside ``jit``), so that
every op rounds its output as its program says: compiled as one program,
XLA:CPU drops some of the bfloat16 roundings between fused ops
(tests/test_torch_bf16_tanet.py).  So each tap and the logits are held to
``BF16_FACTOR`` (3) times the move bfloat16 makes in vitta_tpu's own
forward against its float32 one, as for TANet: two forwards that round at
the same kind of points sit on either side of the float32 one, each about
as far from it.  What that leaves open is held by itself: the activations
and the bfloat16 gradients' dtypes, the float32 masters, taps and logits,
the bfloat16 forward is not the float32 one, and the first norm's
statistics (the patch embedding's conv and one LayerNorm) agree to rtol
2e-2 / atol 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.precompute import compute_source_statistics
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models.layers import Taps, flatten_taps
from vitta_tpu_torch.models.swin import Recognizer3D

torch.set_num_threads(1)

K = 5
EMBED, DEPTHS, HEADS, WINDOW = 128, (2, 1), (4, 8), (2, 3, 3)
PATCH = (2, 4, 4)
T, HW = 4, 48
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
BF16_FACTOR = 3.0
FIRST = "backbone.layers_0.blocks_0.norm1"


def _jax_forward(variables, dtype, x):
    """(logits, {tap name: (mean, var)}) of vitta_tpu's Swin at ``dtype``,
    run op by op."""
    jm = JaxRecognizer3D(drop_path_rate=0.0, dtype=dtype, **MODEL_KW)
    logits, aux = jm.apply(variables, jnp.asarray(x), train=False,
                           mutable=["taps"])
    taps = {n: (np.asarray(s.mean), np.asarray(s.var))
            for n, s in jax_flatten_taps(aux["taps"], "stat").items()}
    return np.asarray(logits), taps


@pytest.fixture(scope="module")
def shared():
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(K, PATCH, EMBED, DEPTHS, HEADS, WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = oracle.state_dict()
    variables = convert_swin_checkpoint(sd, K, depths=DEPTHS,
                                        window_size=WINDOW)
    x = np.random.default_rng(0).normal(size=(2, T, HW, HW, 3)).astype(
        np.float32)
    return dict(sd=sd, x=x, jax32=_jax_forward(variables, "float32", x),
                jax16=_jax_forward(variables, "bfloat16", x))


def _port(sd, dtype, **kw):
    model = Recognizer3D(drop_path_rate=0.0, dtype=dtype, **MODEL_KW, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _assert_near(got, want, ref, what):
    """max|got - want| <= BF16_FACTOR * max|want - ref|."""
    got, want, ref = (np.asarray(a, np.float64) for a in (got, want, ref))
    move = float(np.abs(want - ref).max())
    err = float(np.abs(got - want).max())
    assert err <= BF16_FACTOR * move, (
        f"{what}: {err:.3e} from vitta_tpu at bfloat16, which is "
        f"{move:.3e} from its float32 forward")


def test_logits_and_taps_match_jax_bf16(shared):
    model = _port(shared["sd"], "bfloat16")
    taps = {}
    with torch.no_grad():
        logits = model(torch.from_numpy(shared["x"]), taps)
    (l16, t16), (l32, t32) = shared["jax16"], shared["jax32"]
    assert logits.dtype == torch.float32
    _assert_near(logits.numpy(), l16, l32, "logits")
    got = flatten_taps(taps, "stat")
    assert set(got) == set(t16) and len(got) == 8
    for name, stats in got.items():
        for i, part in enumerate(stats):
            assert part.dtype == torch.float32, name
            _assert_near(part.numpy(), t16[name][i], t32[name][i],
                         f"{name}[{i}]")
    for i in range(2):   # the patch embedding and the first LayerNorm
        np.testing.assert_allclose(got[FIRST][i].numpy(), t16[FIRST][i],
                                   rtol=2e-2, atol=1e-3)


def test_activations_are_bf16_and_the_rest_float32(shared):
    model = _port(shared["sd"], "bfloat16")
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    outputs = {}

    def record(name):
        def hook(module, args, out):
            outputs[name] = out.dtype
        return hook
    for name, m in model.named_modules():
        if name.endswith(("patch_embed", "downsample")) or \
                name.endswith(("blocks.0", "blocks.1")):
            m.register_forward_hook(record(name))
    x = torch.from_numpy(shared["x"]).requires_grad_()
    taps = Taps({"stat"})
    logits = model(x, taps, train=True)
    assert outputs and all(d == torch.bfloat16 for d in outputs.values()), \
        outputs
    (logits.sum() + sum(v["stat"].var.sum() for v in taps.values())
     ).backward()
    assert x.grad.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    # and the bfloat16 forward is not the float32 one
    with torch.no_grad():
        l16 = model(torch.from_numpy(shared["x"]))
        l32 = _port(shared["sd"], "float32")(torch.from_numpy(shared["x"]))
    assert not torch.equal(l16, l32)
    np.testing.assert_allclose(l16.numpy(), l32.numpy(), rtol=0.1,
                               atol=0.05 * float(l32.abs().max()))


@pytest.mark.parametrize("route", ["proj", "ln_proj"])
def test_bf16_swin_builds_the_fused_routes(route, monkeypatch):
    """The projection-fused routes (PERF.md rows 16-19 at bfloat16) build
    at bfloat16 from vitta_tpu's flags (``attn_route=None`` under
    ``VITTA_ATTN_PROJ_FUSED=1``, and ``VITTA_ATTN_LN=1`` for ln_proj) and
    send every block of full windows to the route's op on bfloat16
    activations and weights (tests/test_torch_bf16_swin_proj.py holds their
    values to vitta_tpu's under ``attn_route``)."""
    from vitta_tpu_torch.models import swin as swin_mod
    op = {"proj": "window_attention_proj",
          "ln_proj": "window_attention_ln_proj"}[route]
    dtypes = []

    def spy(*a, _fn=getattr(swin_mod, op), **kw):
        dtypes.append((a[0].dtype, a[4].dtype))
        return _fn(*a, **kw)
    monkeypatch.setattr(swin_mod, op, spy)
    monkeypatch.delenv("VITTA_ATTN_NO_PROJ", raising=False)
    monkeypatch.setenv("VITTA_ATTN_PROJ_FUSED", "1")
    if route == "ln_proj":
        monkeypatch.setenv("VITTA_ATTN_LN", "1")
    else:
        monkeypatch.delenv("VITTA_ATTN_LN", raising=False)
    model = Recognizer3D(dtype="bfloat16", attn_route=None, **MODEL_KW)
    assert all(b.attn_route == route for layer in model.backbone.layers
               for b in layer.blocks)
    with torch.no_grad():
        logits = model(torch.zeros(1, T, HW, HW, 3))
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert dtypes == [(torch.bfloat16, torch.bfloat16)] * sum(DEPTHS)


def test_bf16_swin_refuses_norm2_apart(monkeypatch):
    """Widths that are no multiple of 128 (Swin-T's 96 and 192) and token
    counts that are no multiple of 8 run norm2 apart from the MLP, which
    the bfloat16 Swin no longer refuses (PERF.md rows 8-9 at bfloat16): the
    block takes the bfloat16 ``mlp`` with bfloat16 weights.  float16 is
    still refused."""
    from vitta_tpu_torch.models import swin as swin_mod
    dtypes = []

    def spy(x, w1, b1, w2, b2, *a, _fn=swin_mod.mlp, **kw):
        dtypes.append((x.dtype, w1.dtype, b1.dtype, w2.dtype, b2.dtype))
        return _fn(x, w1, b1, w2, b2, *a, **kw)
    monkeypatch.setattr(swin_mod, "mlp", spy)
    for kw, side in (({**MODEL_KW, "embed_dim": 96}, 48), (MODEL_KW, 24)):
        model = Recognizer3D(dtype="bfloat16", **kw)
        with torch.no_grad():   # 24 x 24: 2 x 3 x 3 tokens at stage 2
            logits = model(torch.zeros(1, T, side, side, 3))
        assert logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
    assert dtypes and all(d == (torch.bfloat16,) * 5 for d in dtypes)
    with pytest.raises(ValueError):
        Recognizer3D(dtype="float16", **MODEL_KW)


def test_get_model_keeps_swin_float32():
    """``get_model`` builds Video Swin at float32 under either
    ``compute_dtype``, as vitta_tpu's dispatch does; the bfloat16 Swin is
    built as ``Recognizer3D(..., dtype="bfloat16")``."""
    cfg = swin_ucf101_preset()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", depths=DEPTHS, num_heads=HEADS,
        window_size=WINDOW))
    assert get_model(cfg).dtype == torch.float32


def test_source_statistics_of_the_bf16_model(shared):
    """``compute_source_statistics`` of the bfloat16 model: float32 means and
    variances of the bfloat16 activations, those of its tapped forward."""
    model = _port(shared["sd"], "bfloat16")
    x = shared["x"]
    stats = compute_source_statistics(model, [(x, np.zeros(2, np.int64))],
                                      device="cpu")
    taps = {}
    with torch.no_grad():
        model(torch.from_numpy(x), taps)
    want = flatten_taps(taps, "stat")
    assert set(stats) == set(want)
    for name, (m, v) in stats.items():
        assert m.dtype == v.dtype == np.float32, name
        np.testing.assert_allclose(m, want[name].mean.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(v, want[name].var.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
