"""Video Swin's layout variants in the port, on the CPU: the window-resident
stage (``VITTA_WINDOW_RESIDENT``) and the patch embedding as a product
(``VITTA_PATCHIFY_V2``).  Each is held against the port's default form and,
with the same flags set in both packages, against vitta_tpu.  vitta_tpu's
flags with no counterpart in the port change nothing in it.

Tolerances, and why:
* window-resident against spatial (the same port): logits and every tap
  rtol 2e-5 / atol 2e-5, gradients rtol 5e-4 / atol 1e-5,
  tests/test_swin_window_resident.py's bounds (the spatiotemp sums over
  the tokens in another order);
* the token gather against reverse + roll + partition: bit for bit, both
  ways (copies);
* the product patch embedding against the Conv3d: 2e-5, gradients 2e-4,
  tests/test_patchify.py's;
* the port against vitta_tpu: logits rtol 2e-3 / atol 2e-4, taps rtol
  1e-3 / atol 1e-5, tests/test_torch_swin.py's; the 3-step trajectory at
  tests/test_torch_swin_engine.py's (losses and EMA rtol 1e-3 / atol 1e-5,
  eval logits 2e-3 / 2e-4, each weight's update within 2% of its norm,
  predictions exactly);
* a flag with no counterpart set against unset: exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import swin_ucf101_preset as jax_preset
from vitta_tpu.models import swin as jswin
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt import precompute
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models import swin
from vitta_tpu_torch.models.layers import flatten_taps
from vitta_tpu_torch.ops import dispatch
from vitta_tpu_torch.utils.checkpoint import swin_state_dict_from_jax

torch.set_num_threads(1)

FLAGS = ("VITTA_WINDOW_RESIDENT", "VITTA_PATCHIFY_V2")
# vitta_tpu's flags that the port does not read (ops/dispatch.py says why)
NO_COUNTERPART = ("VITTA_PATCHIFY", "VITTA_COMPACT_BIAS", "VITTA_NO_HALF_TWIN",
                  "VITTA_ATTN_PIPE", "VITTA_MLP_PIPE", "VITTA_DISABLE_PALLAS")
K = 5
PATCH = (2, 4, 4)
WINDOW = (2, 3, 3)
DEPTHS = (2, 2)
EMBED = 32
HEADS = (2, 4)
T, HW, V = 4, 48, 2
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
# (T, HW): 4 x 48 clamps the time axis (D 2 = the window, as in Swin-B at 16
# frames) and shifts H and W; 8 x 24 shifts all three axes in stage 1 and
# clamps H and W in stage 2
SHAPES = [(4, 48), (8, 24)]
ROUTES = ("packed", "heads", "proj", "ln_proj")


@pytest.fixture(autouse=True)
def flags_unset(monkeypatch):
    for name in FLAGS + NO_COUNTERPART:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _set(monkeypatch, **flags):
    for name, on in flags.items():
        monkeypatch.setenv(name, "1" if on else "0")


def _cfg(preset, t=T, hw=HW, **tta):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t, input_size=hw,
                                 scale_size=hw),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0, **MODEL_KW),
        optim=dataclasses.replace(cfg.optim, lr=1e-3),
        tta=dataclasses.replace(cfg.tta, **tta))


@pytest.fixture(scope="module")
def weights():
    """(the port's seeded state dict, vitta_tpu's variables from it); the
    bias tables wide (std 0.5) so that a wrong bias shows."""
    torch.manual_seed(0)
    model = swin.Recognizer3D(drop_path_rate=0.0, **MODEL_KW)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.5)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return sd, convert_swin_checkpoint(sd, K, depths=DEPTHS,
                                       window_size=WINDOW)


def _port(sd, **kw):
    model = swin.Recognizer3D(**{**MODEL_KW, "drop_path_rate": 0.0, **kw})
    model.load_state_dict(sd, strict=True)
    return model


def _clip(seed, t=T, hw=HW, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, t, hw, hw, 3)).astype(np.float32)


def _forward(model, x, grads=False, **kw):
    """(logits, {tap: {leaf: tensors}}, {param: grad} or None) of one
    tapped forward; the gradients of sum(logits^2) + every tap's sum."""
    taps = {}
    logits = model(torch.from_numpy(x), taps, **kw)
    if not grads:
        return logits.detach(), taps, None
    loss = (logits ** 2).sum() + sum(
        sum(t.sum() for t in v) for slot in taps.values()
        for k, v in slot.items() if k != "stat_n")
    names, params = zip(*model.named_parameters())
    return logits.detach(), taps, dict(zip(names, torch.autograd.grad(
        loss, params)))


def _assert_taps(got, want, rtol, atol):
    assert set(got) == set(want) and got
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for leaf, w in want[name].items():
            if leaf == "stat_n":
                assert got[name][leaf] == w, name
                continue
            for a, b in zip(got[name][leaf], w):
                np.testing.assert_allclose(a.detach().numpy(),
                                           b.detach().numpy(), rtol=rtol,
                                           atol=atol, err_msg=f"{name} {leaf}")


# ---------------------------------------------------------------------------
# the flags


@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("0", False),
                                      ("false", False), ("OFF", False),
                                      ("1", True), ("yes", True)])
@pytest.mark.parametrize("name,read", [
    ("VITTA_WINDOW_RESIDENT", dispatch.window_resident_enabled),
    ("VITTA_PATCHIFY_V2", dispatch.patchify_v2_enabled)])
def test_flags_are_tri_state_and_off_by_default(flags_unset, name, read,
                                                value, on):
    if value is not None:
        flags_unset.setenv(name, value)
    assert read() is on


def test_flags_are_read_when_the_module_is_built(flags_unset):
    """A flag set after the model is built does not move it: each module
    reads its flag once, in its constructor."""
    model = swin.Recognizer3D(**MODEL_KW)
    _set(flags_unset, VITTA_WINDOW_RESIDENT=True, VITTA_PATCHIFY_V2=True)
    assert not any(layer.window_resident for layer in model.backbone.layers)
    assert not model.backbone.patch_embed.patchify_v2
    built = swin.Recognizer3D(**MODEL_KW)
    assert all(layer.window_resident for layer in built.backbone.layers)
    assert built.backbone.patch_embed.patchify_v2
    assert set(built.state_dict()) == set(model.state_dict())


# ---------------------------------------------------------------------------
# the token gather


@pytest.mark.parametrize("dims,window", [
    ((8, 56, 56), (8, 7, 7)), ((8, 28, 28), (8, 7, 7)),
    ((8, 14, 14), (8, 7, 7)), ((8, 7, 7), (8, 7, 7)),
    ((4, 6, 6), (2, 3, 3))], ids=lambda v: "x".join(map(str, v)))
def test_relayout_gather_is_the_three_op_chain_bit_for_bit(dims, window):
    """Entry, a change of shift (both ways) and exit as one gather each,
    against window_partition, window_reverse and torch.roll at every Swin-B
    stage's (D, H, W) (16 x 224², the window clamped as the model clamps
    it) and one shifted in time; the cotangent's way back likewise."""
    b, c = 2, 3
    window, shift = swin.get_window_size(dims, window,
                                         tuple(w // 2 for w in window))
    rng = np.random.default_rng(sum(dims))
    x = torch.from_numpy(rng.normal(size=(b, *dims, c)).astype(np.float32))
    n = int(np.prod(window))

    def gather(t, src, dst):
        index = swin.relayout_index(dims, window, src, dst)
        if index is None:
            return t
        return swin.TokenGather.apply(t, torch.from_numpy(index),
                                      torch.from_numpy(np.argsort(index)))

    def chain(t, src, dst):
        """vitta_tpu's form: reverse, roll, partition (any of them absent
        where src or dst is the grid)."""
        if src is not None:
            t = swin.window_reverse(t.reshape(-1, n, c), window, b, *dims)
            t = torch.roll(t, shifts=src, dims=(1, 2, 3))
        else:
            t = t.reshape(b, *dims, c)
        if dst is None:
            return t.reshape(b, -1, c)
        t = torch.roll(t, shifts=tuple(-s for s in dst), dims=(1, 2, 3))
        return swin.window_partition(t, window).reshape(b, -1, c)

    zero = (0, 0, 0)
    for src, dst in ((None, zero), (zero, shift), (shift, zero),
                     (shift, None), (zero, None)):
        start = x if src is None else chain(x, None, src)
        a = start.reshape(b, -1, c).clone().requires_grad_()
        z = a.detach().clone().requires_grad_()
        got, want = gather(a, src, dst), chain(z, src, dst)
        assert torch.equal(got, want), (src, dst)
        cot = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
        if got.requires_grad:
            got.backward(cot)
            want.backward(cot)
            assert torch.equal(a.grad, z.grad), (src, dst)
    # the entry of a stage whose one window is the whole grid is no gather
    assert (swin.relayout_index(dims, window, None, zero) is None) == (
        window == dims)


# ---------------------------------------------------------------------------
# window-resident against spatial, in the port


@pytest.mark.parametrize("t,hw", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("route", ROUTES)
def test_window_resident_matches_spatial(weights, flags_unset, route, t, hw):
    sd, _variables = weights
    x = _clip(1, t, hw)
    out = {}
    for wr in (False, True):
        _set(flags_unset, VITTA_WINDOW_RESIDENT=wr)
        swin.counters.reset()
        out[wr] = _forward(_port(sd, attn_route=route), x, grads=True)
        assert (swin.counters.window_resident_stages > 0) == wr
        assert swin.counters.contiguity_copies == 0
    (l0, taps0, g0), (l1, taps1, g1) = out[False], out[True]
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=2e-5, atol=2e-5)
    _assert_taps(taps1, taps0, 2e-5, 2e-5)
    assert set(g1) == set(g0)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=5e-4, atol=1e-5, err_msg=name)


def test_window_resident_counts_the_true_batch(weights, flags_unset):
    sd, _variables = weights
    _set(flags_unset, VITTA_WINDOW_RESIDENT=True)
    swin.counters.reset()
    _l, taps, _g = _forward(_port(sd), _clip(2, n=3))
    assert swin.counters.window_resident_stages == len(DEPTHS)
    counts = [slot["stat_n"] for slot in taps.values()]
    assert len(counts) == len(taps) and set(counts) == {3.0}


def test_drop_path_draws_the_same_masks_in_both_forms(weights, flags_unset):
    """Under train=True, one generator seed: the same logits in both
    forms (drop-path draws one value a sample and repeats it over the
    sample's windows), and another seed gives others."""
    sd, _variables = weights
    x = _clip(3)

    def run(wr, seed):
        _set(flags_unset, VITTA_WINDOW_RESIDENT=wr)
        model = _port(sd, drop_path_rate=0.5, head_dropout=0.0)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            logits = model(torch.from_numpy(x), train=True, generator=gen)
        return logits, gen.get_state()

    (a, state_a), (b, state_b) = run(False, 7), run(True, 7)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-5)
    assert torch.equal(state_a, state_b)      # as many values drawn
    other, _ = run(True, 8)
    assert not torch.allclose(other, b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["taps", "indivisible", "clamped"])
def test_the_gate(flags_unset, case):
    """A stage with taps other than spatiotemp, or a dim that does not
    divide by the window, takes the spatial form under the flag; a dim
    smaller than the window is checked against the window as clamped
    (divides, takes the window layout).  Every case gives the spatial
    form's output."""
    dims, stat_types = {"taps": ((4, 6, 6), ("spatiotemp", "temp")),
                        "indivisible": ((4, 5, 5), ("spatiotemp",)),
                        "clamped": ((4, 2, 2), ("spatiotemp",))}[case]
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, *dims, 16)).astype(np.float32))
    out = []
    for wr in (False, True):
        _set(flags_unset, VITTA_WINDOW_RESIDENT=wr)
        torch.manual_seed(5)
        layer = swin.BasicLayer(16, 2, 2, WINDOW, (0.0, 0.0), False, "l",
                                stat_types=stat_types)
        swin.counters.reset()
        with torch.no_grad():
            out.append(layer(x, {}))
        taken = swin.counters.window_resident_stages == 1
        assert taken == (wr and case == "clamped"), (case, wr)
        assert layer.window_resident_ok(x.shape) == taken
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=2e-5,
                               atol=2e-5)


def test_cossim_precompute_refuses_the_window_layout(weights, flags_unset):
    """The relation-map precompute reads each norm's output in token
    layout: it refuses a model built window-resident, and a model built
    with the cossim taps under the flag takes the spatial form and gives
    the values it gives with the flag off."""
    sd, _variables = weights
    batches = [(_clip(12), np.zeros(2, np.int32))]
    want = precompute.compute_cossim_statistics(
        _port(sd, stat_types=("cossim",)), batches, clip_len=T, device="cpu")
    _set(flags_unset, VITTA_WINDOW_RESIDENT=True)
    with pytest.raises(ValueError, match="VITTA_WINDOW_RESIDENT"):
        precompute.compute_cossim_statistics(_port(sd), batches, clip_len=T,
                                             device="cpu")
    model = _port(sd, stat_types=("cossim",))
    assert not any(layer.window_resident for layer in model.backbone.layers)
    got = precompute.compute_cossim_statistics(model, batches, clip_len=T,
                                               device="cpu")
    assert set(got) == set(want) and got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# the port against vitta_tpu, the same flags in both


@pytest.mark.parametrize("v2", [False, True], ids=["conv", "product"])
@pytest.mark.parametrize("wr", [False, True], ids=["spatial", "resident"])
def test_port_matches_vitta_tpu_under_the_same_flags(weights, flags_unset,
                                                     wr, v2):
    sd, variables = weights
    _set(flags_unset, VITTA_WINDOW_RESIDENT=wr, VITTA_PATCHIFY_V2=v2)
    x = _clip(5)
    want, aux = jswin.Recognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(x), train=False, mutable=["taps"])
    swin.counters.reset()
    got, taps, _g = _forward(_port(sd), x)
    assert (swin.counters.window_resident_stages > 0) == wr
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)
    for leaf in ("stat", "stat_in"):
        mine, theirs = flatten_taps(taps, leaf), jax_flatten_taps(
            aux["taps"], leaf)
        assert set(mine) == set(theirs) and mine
        for name, s in mine.items():
            for a, b in zip(s, theirs[name]):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                           rtol=1e-3, atol=1e-5,
                                           err_msg=f"{leaf} {name}")


# ---------------------------------------------------------------------------
# the patch embedding as a product


def test_patchify_orders_are_vitta_tpus():
    x = np.arange(2 * 4 * 8 * 8 * 3, dtype=np.float32).reshape(2, 4, 8, 8, 3)
    np.testing.assert_array_equal(
        swin.patchify_mm(torch.from_numpy(x), PATCH).numpy(),
        np.asarray(jswin.patchify_mm(jnp.asarray(x), PATCH)))
    # the Conv3d weight (C, 3, pd, ph, pw) flattened is kernel_mm's rows
    w = np.arange(5 * 3 * 2 * 4 * 4, dtype=np.float32).reshape(5, 3, 2, 4, 4)
    kernel = jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))   # flax's layout
    np.testing.assert_array_equal(w.reshape(5, -1).T,
                                  np.asarray(jswin.kernel_mm(kernel)))


def test_product_embedding_matches_the_conv(weights, flags_unset):
    """The product embedding against the Conv3d: output and every
    parameter's gradient."""
    sd, _variables = weights
    x = torch.from_numpy(_clip(6))
    out = {}
    for v2 in (False, True):
        _set(flags_unset, VITTA_PATCHIFY_V2=v2)
        embed = _port(sd).backbone.patch_embed
        y = embed(x)
        params = list(embed.parameters())
        out[v2] = (y.detach(), torch.autograd.grad((y ** 2).sum(), params))
    (y0, g0), (y1, g1) = out[False], out[True]
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-5, atol=2e-5)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


def _unit_source():
    """Source statistics of mean 0 and variance 1 at every tapped layer."""
    model = swin.Recognizer3D(**MODEL_KW)
    return {m.tap_name: (np.zeros(m.features, np.float32),
                         np.ones(m.features, np.float32))
            for m in model.modules()
            if isinstance(m, swin.LayerNorm) and m.tap}


# ---------------------------------------------------------------------------
# vitta_tpu's flags with no counterpart


@pytest.mark.parametrize("name", NO_COUNTERPART)
def test_flags_without_a_counterpart_change_nothing(weights, flags_unset,
                                                    name):
    """Set to 1, each of vitta_tpu's flags that the port does not read
    leaves a bfloat16 Swin on the packed route (the compact bias, the half
    twin) and its engine (the uint8 frames) as they are unset: the same
    engine form and the same bits of the adapt step's losses."""
    sd, _variables = weights
    cfg = _cfg(swin_ucf101_preset)
    src = _unit_source()
    rng = np.random.default_rng(11)
    views = rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8)
    clip = rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8)
    label = np.asarray([1], np.int32)
    out = []
    for value in (None, "1"):
        if value is not None:
            flags_unset.setenv(name, value)
        eng = VittaEngine(_port(sd, dtype="bfloat16"), cfg, sd, src,
                          device="cpu")
        assert eng._twin is not None
        assert eng._maybe_normalize(clip).shape == clip.shape
        _state, m = eng.adapt_eval_step(eng.init_state(), views, clip, label)
        out.append([float(getattr(m, f)) for f in ("loss_reg", "loss_consis",
                                                   "loss_ce")])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# a trajectory under both variants against vitta_tpu's default


def test_trajectory_with_both_variants_matches_vitta_tpu(weights,
                                                         flags_unset):
    """3 tta_online steps of the port with the window-resident stages and
    the product patch embedding against vitta_tpu's engine with its
    defaults (both on there): losses, EMA, eval logits, weights."""
    sd, variables = weights
    clean = _clip(100, n=V)
    _, aux = jswin.Recognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"]).items()}
    jeng = JaxEngine(jswin.Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                        **MODEL_KW),
                     _cfg(jax_preset), variables, src, donate=False)
    _set(flags_unset, VITTA_WINDOW_RESIDENT=True, VITTA_PATCHIFY_V2=True)
    eng = VittaEngine(_port(sd, head_dropout=0.0), _cfg(swin_ucf101_preset),
                      sd, src, device="cpu")
    assert eng.tap_names == tuple(jeng.tap_names) and eng.tap_names
    jstate, state = jeng.init_state(), eng.init_state()
    rng = np.random.default_rng(9)
    swin.counters.reset()
    for i in range(3):
        views = rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8)
        clip = rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8)
        label = np.asarray([i % K], np.int32)
        jstate, jm = jeng.adapt_eval_step(
            jstate, jnp.asarray(views), jnp.asarray(clip), jnp.asarray(label),
            jax.random.fold_in(jax.random.PRNGKey(0), i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jm, field)), rtol=1e-3,
                                       atol=1e-5, err_msg=f"{field} step {i}")
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
        np.testing.assert_allclose(
            eng.eval_logits(clip).numpy(),
            np.asarray(jeng._apply_eval(jstate.params, jnp.asarray(clip))),
            rtol=2e-3, atol=2e-4, err_msg=f"eval logits step {i}")
        for name, stats in state.ema.items():
            for g, w in zip(stats, jstate.ema[name]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-3, atol=1e-5,
                                           err_msg=f"ema {name}")
    # 2 stages x (adapt forward + eval forward) x 3 steps, and the checks'
    assert swin.counters.window_resident_stages >= 2 * 2 * 3
    want = swin_state_dict_from_jax({"params": jstate.params}, depths=DEPTHS,
                                    window_size=WINDOW)
    for k, p in eng.model.named_parameters():
        init = sd[k].numpy()
        dj, dp = want[k].numpy() - init, p.detach().numpy() - init
        assert np.linalg.norm(dp - dj) <= 2e-2 * np.linalg.norm(dj) + 1e-8, k
