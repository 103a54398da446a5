"""The bfloat16 forms of the Video Swin-B kernels (PERF.md rows 3, 4, 10, 11,
14 and 15: LayerNorm, LayerNorm-MLP and packed attention, forward and
backward) against vitta_tpu's Pallas kernels at bfloat16, on the CPU.

The same numpy-seeded inputs, rounded to bfloat16 once, go through the
Pallas kernel in interpret mode (as vitta_tpu's own tests run them) and
through the port's plain version, the twin its CUDA kernel is held to on the
card (tests/test_torch_cuda.py, chip_smoke.py).  Weights are passed in each
package's layout (the port's nn.Linear (out, in), vitta_tpu's (in, out)).
The backward of each pair takes the same residuals in both packages
(vitta_tpu's forward outputs), so that it is compared on equal inputs.

Tolerances, fixed before the comparisons, and why:
* a bfloat16 output within one bfloat16 ulp of vitta_tpu's, or a floor of
  the tensor's largest magnitude.  Both round the same float32 value once,
  computed by formulas whose float32 sums run in other orders, so a value
  may round the other way (one ulp).  The floor is ``DIRECT`` (2^-20) where
  the output is one such rounding (the LayerNorm's y and dx, the MLP's y, a
  and s, the bias and weight gradients of sums of exact products): a value
  near 0 there is the difference of larger float32 terms, or, for a and s,
  vitta_tpu's erf (a rational approximation, 4e-7 absolute,
  pallas_mlp.py:50-62) against erf itself.  It is ``CHAINED`` (2^-12)
  where the output is made from an intermediate that the op rounds inside
  (the MLP's o from a, its dx and dw1 from dh; the attention's out from e
  and its dqkv from gs and dl): such an intermediate is one ulp apart in a
  few values, and each moves an output by about 2^-8 of one term of its
  sum, below 2^-12 of the largest output at these sizes.
* float32 outputs: the LayerNorm's dgamma and dbeta to 1e-5 of their
  largest value (float32 sums in another order); the LayerNorm-MLP's to
  5e-5 (their dy is summed from dh, whose rounded form differs in a few
  values); the attention's ms at rtol 1e-5 / atol 1e-6 and dbias to 1e-5
  of its largest value (float32 sums of float32 terms).
The share of values that differ by an ulp is printed (``pytest -s``) and
held below ``MAX_APART`` (1%): a rounding point moved by a whole op would
set most values apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import _packed_attn_bwd, _packed_attn_fwd
from vitta_tpu.ops.pallas_ln import _ln_bwd, _ln_fwd
from vitta_tpu.ops.pallas_mlp import _pallas_lnmlp_bwd, _pallas_lnmlp_fwd
from vitta_tpu_torch.ops.cuda_attention import (
    packed_attention_bf16_backward_reference, window_attention_packed)
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
from vitta_tpu_torch.ops.cuda_ln import (layer_norm,
                                         layer_norm_backward_reference)
from vitta_tpu_torch.ops.cuda_mlp import ln_mlp, ln_mlp_backward_reference

torch.set_num_threads(1)

BF16 = torch.bfloat16
DIRECT = 2.0 ** -20
CHAINED = 2.0 ** -12
MAX_APART = 0.01


def _jbf16(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _t(a):
    """A JAX or numpy array as a tensor of its dtype (bfloat16 stays)."""
    arr = jnp.asarray(a)
    t = torch.from_numpy(np.asarray(arr.astype(jnp.float32)).copy())
    return t.to(BF16) if arr.dtype == jnp.bfloat16 else t


def _assert_ulp(name, got, want, floor):
    """|got - want| <= max(one bfloat16 ulp of |want|, floor * max|want|);
    the share of values apart stays below MAX_APART."""
    assert got.dtype == BF16, (name, got.dtype)
    g = got.float().numpy().astype(np.float64)
    w = (want.float().numpy() if isinstance(want, torch.Tensor)
         else np.asarray(jnp.asarray(want).astype(jnp.float32))).astype(
             np.float64)
    assert g.shape == w.shape, name
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    tol = np.maximum(ulp, floor * np.abs(w).max())
    bad = np.abs(g - w) > tol
    apart = float((g != w).mean())
    print(f"{name}: {apart:.2e} of values an ulp apart")
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} values beyond one ulp, worst "
        f"{np.abs(g - w).max():.3e} on values up to {np.abs(w).max():.3e}")
    assert apart <= MAX_APART, (name, apart)


def _assert_rel(name, got, want, rel):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64).reshape(g.shape)
    err = float(np.abs(g - w).max())
    assert err <= rel * np.abs(w).max(), (name, err, np.abs(w).max())


# ---------------------------------------------------------------- LayerNorm
@pytest.mark.parametrize("rows,c", [(64, 128), (40, 256), (24, 512),
                                    (16, 1024), (30, 96)])
def test_layer_norm_bf16_matches_pallas(rows, c):
    rng = np.random.default_rng(rows * 1000 + c)
    x = _jbf16(rng.normal(size=(rows, c)) * 2 + 0.5)
    g = jnp.asarray(rng.normal(size=c), jnp.float32)
    b = jnp.asarray(rng.normal(size=c), jnp.float32)
    dy = _jbf16(rng.normal(size=(rows, c)))
    y = _ln_fwd(x, g, b, 1e-5, interpret=True)
    dx, dg, db = _ln_bwd(x, g, dy, 1e-5, interpret=True)
    assert y.dtype == dx.dtype == jnp.bfloat16
    got = layer_norm(_t(x), _t(g), _t(b), 1e-5)
    _assert_ulp("y", got, y, DIRECT)
    gx, gg, gb = layer_norm_backward_reference(_t(x), _t(g), _t(dy), 1e-5)
    _assert_ulp("dx", gx, dx, DIRECT)
    assert gg.dtype == gb.dtype == torch.float32
    _assert_rel("dgamma", gg, dg, 1e-5)
    _assert_rel("dbeta", gb, db, 1e-5)


def test_layer_norm_bf16_autograd_rounds_where_the_twin_does():
    """On the CPU the bfloat16 LayerNorm differentiates through its plain
    forward; its gradients are the backward twin's within one ulp."""
    rng = np.random.default_rng(7)
    x = _t(_jbf16(rng.normal(size=(48, 256)) * 2 + 0.5)).requires_grad_()
    g = torch.tensor(rng.normal(size=256), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.normal(size=256), dtype=torch.float32,
                     requires_grad=True)
    dy = _t(_jbf16(rng.normal(size=(48, 256))))
    y = layer_norm(x, g, b)
    assert y.dtype == BF16
    y.backward(dy)
    want = layer_norm_backward_reference(x.detach(), g.detach(), dy)
    _assert_ulp("dx", x.grad, want[0], DIRECT)
    _assert_rel("dgamma", g.grad, want[1], 1e-5)
    _assert_rel("dbeta", b.grad, want[2], 1e-5)


# ------------------------------------------------------------ LayerNorm-MLP
def _mlp_inputs(m, c, seed):
    f = 4 * c
    rng = np.random.default_rng(seed)
    return dict(
        x=_jbf16(rng.normal(size=(m, c)) * 2 + 0.5),
        g=jnp.asarray(1 + 0.1 * rng.normal(size=c), jnp.float32),
        bt=jnp.asarray(0.1 * rng.normal(size=c), jnp.float32),
        w1=_jbf16(rng.normal(size=(c, f)) / np.sqrt(c)),      # (in, out)
        b1=_jbf16(0.1 * rng.normal(size=f)),
        w2=_jbf16(rng.normal(size=(f, c)) / np.sqrt(f)),
        b2=_jbf16(0.1 * rng.normal(size=c)),
        go=_jbf16(rng.normal(size=(m, c))),
        gy=_jbf16(0.1 * rng.normal(size=(m, c))))


@pytest.mark.parametrize("m,c", [(64, 128), (40, 256), (24, 512)])
def test_ln_mlp_bf16_matches_pallas(m, c):
    p = _mlp_inputs(m, c, m * 7 + c)
    o, y, a, s = _pallas_lnmlp_fwd(p["x"], p["g"], p["bt"], p["w1"], p["b1"],
                                   p["w2"], p["b2"], 1e-5, True,
                                   interpret=True)
    w1, w2 = _t(p["w1"]).t().contiguous(), _t(p["w2"]).t().contiguous()
    got = ln_mlp(_t(p["x"]), _t(p["g"]), _t(p["bt"]), w1, _t(p["b1"]), w2,
                 _t(p["b2"]), 1e-5, save_residuals=True)
    for name, ours, theirs, floor in (("o", got[0], o, CHAINED),
                                      ("y", got[1], y, DIRECT),
                                      ("a", got[2], a, DIRECT),
                                      ("s", got[3], s, DIRECT)):
        _assert_ulp(name, ours, theirs, floor)
    for gy in (p["gy"], None):
        want = _pallas_lnmlp_bwd(
            p["x"], y, a, s, p["go"],
            jnp.zeros_like(p["go"]) if gy is None else gy, p["g"], p["w1"],
            p["w2"], 1e-5, interpret=True)
        dx, dg, dbt, dw1, dw2, db1, db2 = want
        res = ln_mlp_backward_reference(
            _t(p["x"]), _t(y), _t(a), _t(s), _t(p["go"]),
            None if gy is None else _t(gy), _t(p["g"]), w1, w2, 1e-5)
        _assert_ulp("dx", res[0], dx, CHAINED)
        _assert_rel("dgamma", res[1], dg, 5e-5)
        _assert_rel("dbeta", res[2], dbt, 5e-5)
        bf = jnp.bfloat16
        _assert_ulp("dw1", res[3].t(), dw1.astype(bf), CHAINED)
        _assert_ulp("db1", res[4], db1[0].astype(bf), DIRECT)
        _assert_ulp("dw2", res[5].t(), dw2.astype(bf), DIRECT)
        _assert_ulp("db2", res[6], db2[0].astype(bf), DIRECT)


def test_ln_mlp_bf16_autograd_is_the_backward_twin():
    """On the CPU a bfloat16 ``ln_mlp`` under autograd runs the plain
    backward (``LayerNormMlpPlain``): the gradients are exactly the twin's,
    bfloat16 for the MLP's weights, float32 for gamma and beta."""
    p = _mlp_inputs(40, 128, 3)
    ins = [_t(p[k]) for k in ("x", "g", "bt")] + [
        _t(p["w1"]).t().contiguous(), _t(p["b1"]),
        _t(p["w2"]).t().contiguous(), _t(p["b2"])]
    ins = [t.requires_grad_() for t in ins]
    o, y = ln_mlp(*ins)
    go, gy = _t(p["go"]), _t(p["gy"])
    torch.autograd.backward([o, y], [go, gy])
    _o, y2, a, s = ln_mlp(*[t.detach() for t in ins], save_residuals=True)
    want = ln_mlp_backward_reference(ins[0].detach(), y2, a, s, go, gy,
                                     ins[1].detach(), ins[3].detach(),
                                     ins[5].detach())
    order = (0, 1, 2, 3, 4, 5, 6)
    for i, w in zip(order, want):
        assert ins[i].grad.dtype == ins[i].dtype
        assert torch.equal(ins[i].grad, w), i


# ----------------------------------------------------------- packed attention
def _attn_inputs(b_, nh, hd, window, nw, seed):
    wd, wh, ww = window
    n = wd * wh * ww
    rng = np.random.default_rng(seed)
    qkv = _jbf16(rng.normal(size=(b_, n, 3 * nh * hd)))
    vc = rng.normal(size=(nh, 2 * wd - 1, wh * ww, wh * ww)) * 0.5
    bias = expand_bias_reference(torch.tensor(vc, dtype=torch.float32),
                                 wd).numpy()
    mask = None
    if nw:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
        mask[:, np.arange(n), np.arange(n)] = 0.0
        mask = mask.astype(np.float32)
    g = _jbf16(rng.normal(size=(b_, n, nh * hd)))
    return qkv, bias, mask, g


@pytest.mark.parametrize("b_,nh,hd,window,nw", [
    (8, 2, 16, (2, 3, 3), 4), (4, 4, 32, (2, 3, 3), 0),
    (2, 2, 32, (4, 7, 7), 2)])
def test_packed_attention_bf16_matches_pallas(b_, nh, hd, window, nw):
    qkv, bias, mask, g = _attn_inputs(b_, nh, hd, window, nw, b_ * nh + hd)
    scale = hd ** -0.5
    jmask = None if mask is None else jnp.asarray(mask)
    out, ms = _packed_attn_fwd(qkv, jnp.asarray(bias), jmask, scale, nh,
                               save_ms=True, interpret=True)
    assert out.dtype == jnp.bfloat16 and ms.dtype == jnp.float32
    tmask = None if mask is None else torch.from_numpy(mask)
    got, got_ms = window_attention_packed(_t(qkv), torch.from_numpy(bias),
                                          tmask, scale, nh, save_ms=True)
    _assert_ulp("out", got, out, CHAINED)
    np.testing.assert_allclose(got_ms.numpy(), np.asarray(ms), rtol=1e-5,
                               atol=1e-6)
    dqkv, dbias = _packed_attn_bwd(qkv, jnp.asarray(bias), jmask, ms, g,
                                   scale, nh, interpret=True)
    gq, gb = packed_attention_bf16_backward_reference(
        _t(qkv), torch.from_numpy(bias), tmask, _t(ms), _t(g), scale, nh)
    _assert_ulp("dqkv", gq, dqkv, CHAINED)
    assert gb.dtype == torch.float32
    _assert_rel("dbias", gb, dbias, 1e-5)


def test_packed_attention_bf16_autograd_is_the_backward_twin():
    """On the CPU a bfloat16 qkv under autograd runs the plain backward
    (``PackedAttentionPlain``): dqkv bfloat16 and dbias float32, exactly
    the twin's."""
    qkv, bias, mask, g = _attn_inputs(4, 2, 16, (2, 3, 3), 2, 5)
    q = _t(qkv).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    tmask = torch.from_numpy(mask)
    out = window_attention_packed(q, bt, tmask, 0.25, 2)
    assert out.dtype == BF16
    out.backward(_t(g))
    _o, ms = window_attention_packed(q.detach(), bt.detach(), tmask, 0.25, 2,
                                     save_ms=True)
    want = packed_attention_bf16_backward_reference(
        q.detach(), bt.detach(), tmask, ms, _t(g), 0.25, 2)
    assert q.grad.dtype == BF16 and bt.grad.dtype == torch.float32
    assert torch.equal(q.grad, want[0]) and torch.equal(bt.grad, want[1])


@pytest.mark.parametrize("b_,nh,hd,window,nw", [
    (8, 2, 16, (2, 3, 3), 4), (2, 2, 32, (4, 7, 7), 0)])
def test_attention_bf16_check_stages_rebuild_the_twins(b_, nh, hd, window,
                                                       nw):
    """The staged plain versions the card's checks hold the attention
    kernels to (vitta_tpu_torch/tools/bf16_checks.py), fed the twins' own
    e and dl, give the twins' out and dqkv bit for bit: they round where
    the twins round, and differ from them only in where e and dl come
    from."""
    from vitta_tpu_torch.ops.cuda_attention import (
        packed_attention_bf16_reference)
    from vitta_tpu_torch.tools.bf16_checks import (
        packed_attention_bf16_bwd_stages, packed_attention_bf16_fwd_stage,
        packed_attention_bf16_intermediates)
    qkv, bias, mask, g = _attn_inputs(b_, nh, hd, window, nw, b_ + nh)
    qkv, g, bias = _t(qkv), _t(g), torch.from_numpy(bias)
    tmask = None if mask is None else torch.from_numpy(mask)
    scale = hd ** -0.5
    out, ms = packed_attention_bf16_reference(qkv, bias, tmask, scale, nh,
                                              save_ms=True)
    e, dl = packed_attention_bf16_intermediates(qkv, bias, tmask, ms, g,
                                                scale, nh)
    assert e.dtype == BF16 and dl.dtype == torch.float32
    assert e.shape == dl.shape == (b_, nh, qkv.shape[1], qkv.shape[1])
    assert torch.equal(packed_attention_bf16_fwd_stage(qkv, ms, e, nh), out)
    dqkv, _db = packed_attention_bf16_backward_reference(qkv, bias, tmask, ms,
                                                         g, scale, nh)
    assert torch.equal(
        packed_attention_bf16_bwd_stages(qkv, ms, g, e, dl, scale, nh), dqkv)
