"""The bfloat16 forms of the kernels Video Swin-T adds to Swin-B's (PERF.md
rows 8, 9, 12 and 13: the MLP without the LayerNorm and the attention per
(head, window), forward and backward) against vitta_tpu's Pallas kernels at
bfloat16, on the CPU.

The same numpy-seeded inputs, rounded to bfloat16 once, go through the
Pallas kernel in interpret mode (as vitta_tpu's own tests run them) and
through the port's plain version, the twin its CUDA kernel is held to on the
card (tests/test_torch_cuda.py, chip_smoke.py).  Weights are passed in each
package's layout (the port's nn.Linear (out, in), vitta_tpu's (in, out));
q, k and v as vitta_tpu's head-major (nh, B_, N, hd) tensors and as the
port's views of one packed projection output.  Each backward takes the same
residuals in both packages: vitta_tpu's a and s; for the attention, whose
TPU kernel rebuilds the row maximum and sum from the logits, the port's
forward's (the same float32 values of the same logits).

Tolerances: those of tests/test_torch_bf16_swin_kernels.py and of the
card's checks (vitta_tpu_torch/tools/bf16_checks.py), for the same reasons.
A bfloat16 output within one bfloat16 ulp of vitta_tpu's or a floor of its
tensor's largest magnitude: ``DIRECT`` (2^-20) where both round one float32
value of the same rounded inputs (the MLP's a and s; its dw2, db1 and db2),
``CHAINED`` (2^-12) where the output is made from an intermediate the op
rounds inside (the MLP's o from a).  At most 1% of the values an ulp apart.

Two outputs are held on the intermediate each package rounds for itself,
since ``CHAINED``'s reason (an ulp of one term of a sum lies below 2^-12 of
the largest output) fails where a sum has few or dominant terms:
* the MLP's dx and dw1, made from dhc, the rounded dh, over 24 to 64 rows
  here: vitta_tpu's dhc is rebuilt outside its kernel by the kernel's own
  first product (it gives vitta_tpu's dx and dw1 bit for bit, which the
  test asserts), the port's dhc is held within one ulp of it, and the
  port's steps from vitta_tpu's dhc to ``DIRECT``;
* the attention's out, dq, dk and dv, made from the rounded e and dl, whose
  softmax a few keys dominate: vitta_tpu's e is not handed out, so they are
  held as the card holds them end to end
  (``bf16_checks.assert_bf16_mostly_within``): at most 1e-4 of the values
  beyond one ulp or 2^-12 of the largest magnitude, and those within 2^-7
  of the absolute products through e and dl
  (``heads_attention_bf16_slack``).
The attention's dbias (float32) to 1e-5 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_swin_kernels import (BF16, CHAINED, DIRECT,
                                                MAX_APART, _assert_rel,
                                                _assert_ulp, _jbf16, _t)
from vitta_tpu.ops.pallas_attention import _pallas_attn_bwd, _pallas_attn_fwd
from vitta_tpu.ops.pallas_mlp import _pallas_mlp_bwd, _pallas_mlp_fwd
from vitta_tpu_torch.ops.cuda_attention import (
    heads_attention_bf16_backward_reference, heads_attention_bf16_reference,
    window_attention_heads)
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
from vitta_tpu_torch.ops.cuda_mlp import (mlp, mlp_bf16_backward_reference,
                                          mlp_bf16_reference)
from vitta_tpu_torch.tools import bf16_checks

torch.set_num_threads(1)

MLP_SHAPES = [(64, 96), (40, 192), (24, 48)]
# (B_, nh, hd, window, nW): nh 3 and 6, hd 16 and 32, with and without the
# shift mask
ATTN_CASES = [(8, 3, 16, (2, 3, 3), 4), (4, 6, 32, (2, 3, 3), 0),
              (2, 3, 32, (4, 7, 7), 2), (4, 6, 16, (2, 3, 3), 2)]


# ------------------------------------------------- the MLP without LayerNorm
def _mlp_inputs(m, c, seed):
    f = 4 * c
    rng = np.random.default_rng(seed)
    return dict(
        x=_jbf16(rng.normal(size=(m, c)) * 1.5),
        w1=_jbf16(rng.normal(size=(c, f)) / np.sqrt(c)),      # (in, out)
        b1=_jbf16(0.1 * rng.normal(size=f)),
        w2=_jbf16(rng.normal(size=(f, c)) / np.sqrt(f)),
        b2=_jbf16(0.1 * rng.normal(size=c)),
        g=_jbf16(rng.normal(size=(m, c))))


def _port_weights(p):
    """w1 (F, C), b1, w2 (C, F), b2 as the port takes them."""
    return (_t(p["w1"]).t().contiguous(), _t(p["b1"]),
            _t(p["w2"]).t().contiguous(), _t(p["b2"]))


@pytest.mark.parametrize("m,c", MLP_SHAPES, ids=str)
def test_mlp_bf16_matches_pallas(m, c):
    p = _mlp_inputs(m, c, m * 7 + c)
    o, a, s = _pallas_mlp_fwd(p["x"], p["w1"], p["b1"], p["w2"], p["b2"],
                              True, interpret=True)
    assert o.dtype == a.dtype == s.dtype == jnp.bfloat16
    w1, b1, w2, b2 = _port_weights(p)
    got = mlp(_t(p["x"]), w1, b1, w2, b2, save_residuals=True)
    for name, ours, theirs, floor in (("o", got[0], o, CHAINED),
                                      ("a", got[1], a, DIRECT),
                                      ("s", got[2], s, DIRECT)):
        _assert_ulp(name, ours, theirs, floor)
    assert torch.equal(mlp_bf16_reference(_t(p["x"]), w1, b1, w2, b2),
                       got[0])
    dx, dw1, dw2, db1, db2 = _pallas_mlp_bwd(p["x"], a, s, p["g"], p["w1"],
                                             p["w2"], interpret=True)
    bf, f32 = jnp.bfloat16, jnp.float32
    # vitta_tpu's dhc, by its kernel's first product outside the kernel: it
    # gives the kernel's dx and dw1 bit for bit
    dot = lambda u, w, ax: jax.lax.dot_general(
        u, w, (ax, ((), ())), preferred_element_type=f32)
    dhc = (dot(p["g"], p["w2"], ((1,), (1,))) * s.astype(f32)).astype(bf)
    assert bool((dot(dhc, p["w1"], ((1,), (1,))).astype(bf) == dx).all())
    assert bool((dot(p["x"], dhc, ((0,), (0,))) == dw1).all())
    # the port's steps: its own dh (rounded: its dhc), and its products
    # from vitta_tpu's dhc
    x, g, ta, ts = _t(p["x"]), _t(p["g"]), _t(a), _t(s)
    dh = (g.float() @ w2.float()) * ts.float()
    steps = bf16_checks.mlp_bwd_stages(x, ta, ts, g, w1, w2, dh, _t(dhc))
    res = mlp_bf16_backward_reference(x, ta, ts, g, w1, w2)
    assert torch.equal(steps["db1"], res[2])
    # vitta_tpu's VJP rounds the weight and bias gradients
    for name, theirs in (("dhc", dhc), ("dx", dx), ("dw1", dw1.T.astype(bf)),
                         ("db1", db1[0].astype(bf)), ("dw2", dw2.T.astype(bf)),
                         ("db2", db2[0].astype(bf))):
        _assert_ulp(name, steps[name], theirs, DIRECT)


def test_mlp_bf16_autograd_is_the_backward_twin():
    """On the CPU a bfloat16 ``mlp`` under autograd runs the plain backward
    (``MlpPlain``): the gradients are exactly the twin's, bfloat16 for x and
    the weights and biases."""
    p = _mlp_inputs(40, 96, 3)
    ins = [_t(p["x"]), *_port_weights(p)]
    ins = [t.requires_grad_() for t in ins]
    o = mlp(*ins)
    assert o.dtype == BF16
    o.backward(_t(p["g"]))
    x, w1, b1, w2, b2 = (t.detach() for t in ins)
    _o, a, s = mlp(x, w1, b1, w2, b2, save_residuals=True)
    want = mlp_bf16_backward_reference(x, a, s, _t(p["g"]), w1, w2)
    for t, w in zip(ins, want):
        assert t.grad.dtype == BF16
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("m,c", MLP_SHAPES[:2], ids=str)
def test_mlp_bf16_check_stages_rebuild_the_twins(m, c):
    """The staged plain versions the card's checks hold the MLP kernels to
    (tools/bf16_checks.py), fed the twins' own a, dh and dhc, give the
    twins' outputs bit for bit."""
    p = _mlp_inputs(m, c, m + c)
    x, g = _t(p["x"]), _t(p["g"])
    w1, b1, w2, b2 = _port_weights(p)
    o, a, s = mlp_bf16_reference(x, w1, b1, w2, b2, save_residuals=True)
    for got, want in zip(bf16_checks.mlp_fwd_stages(x, w1, b1, w2, b2, a),
                         (o, a, s)):
        assert torch.equal(got, want)
    dh = (g.float() @ w2.float()) * s.float()
    stages = bf16_checks.mlp_bwd_stages(x, a, s, g, w1, w2, dh,
                                        dh.to(BF16))
    assert torch.equal(stages["dh"], dh)
    want = mlp_bf16_backward_reference(x, a, s, g, w1, w2)
    for name, w in zip(("dx", "dw1", "db1", "dw2", "db2"), want):
        assert torch.equal(stages[name], w), name


# -------------------------------------------- attention per (head, window)
def _attn_inputs(b_, nh, hd, window, nw, seed):
    """(packed qkv bfloat16 (B_, N, 3 nh hd), dense bias, mask or None, the
    cotangent bfloat16 (B_, N, nh, hd)) as numpy / JAX arrays."""
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
    g = _jbf16(rng.normal(size=(b_, n, nh, hd)))
    return qkv, bias, mask, g


def _views(qkv, nh):
    """q, k, v (B_, N, nh, hd) as views of the packed tensor, the model's
    form."""
    b_, n, c3 = qkv.shape
    return qkv.reshape(b_, n, 3, nh, c3 // 3 // nh).unbind(2)


def _head_major(t):
    """(B_, N, nh, hd) -> vitta_tpu's (nh, B_, N, hd), and back."""
    return jnp.transpose(t, (2, 0, 1, 3))


@pytest.mark.parametrize("b_,nh,hd,window,nw", ATTN_CASES, ids=str)
def test_heads_attention_bf16_matches_pallas(b_, nh, hd, window, nw):
    qkv, bias, mask, g = _attn_inputs(b_, nh, hd, window, nw, b_ * nh + hd)
    scale = hd ** -0.5
    n = qkv.shape[1]
    q5 = qkv.reshape(b_, n, 3, nh, hd)
    q3, k3, v3 = (_head_major(q5[:, :, i]) for i in range(3))
    # vitta_tpu hands its kernels the mask at bfloat16 (exact: 0 and -100)
    jmask = None if mask is None else jnp.asarray(mask).astype(jnp.bfloat16)
    out = _pallas_attn_fwd(q3, k3, v3, jnp.asarray(bias), jmask, scale,
                           interpret=True)
    assert out.dtype == jnp.bfloat16
    tq, tk, tv = _views(_t(qkv), nh)
    tmask = None if mask is None else torch.from_numpy(mask)
    tbias = torch.from_numpy(bias)
    got, ms = heads_attention_bf16_reference(tq, tk, tv, tbias, tmask, scale,
                                             save_ms=True)
    assert torch.equal(window_attention_heads(tq, tk, tv, tbias, tmask,
                                              scale), got)
    slack = bf16_checks.heads_attention_bf16_slack(tq, tk, tv, tbias, tmask,
                                                   ms, _t(g), scale)
    dq, dk, dv, dbias = _pallas_attn_bwd(q3, k3, v3, jnp.asarray(bias),
                                         jmask, _head_major(g), scale,
                                         interpret=True)
    res = heads_attention_bf16_backward_reference(tq, tk, tv, tbias, tmask,
                                                  ms, _t(g), scale)
    for name, ours, theirs, sl in zip(("out", "dq", "dk", "dv"),
                                      (got,) + res[:3], (out, dq, dk, dv),
                                      slack):
        apart = bf16_checks.assert_bf16_mostly_within(
            name, ours, _t(jnp.transpose(theirs, (1, 2, 0, 3))), sl)
        print(f"{name}: {apart[0]:.2e} of values an ulp apart, "
              f"{apart[3]:.2e} beyond it")
        assert apart[0] <= MAX_APART, (name, apart)
    assert res[3].dtype == torch.float32
    _assert_rel("dbias", res[3], dbias, 1e-5)


def test_heads_attention_bf16_autograd_is_the_backward_twin():
    """On the CPU bfloat16 q, k, v under autograd run the plain backward
    (``HeadsAttentionPlain``): dq, dk, dv bfloat16 (through the views, dqkv)
    and dbias float32, exactly the twin's."""
    qkv, bias, mask, g = _attn_inputs(4, 3, 16, (2, 3, 3), 2, 5)
    packed = _t(qkv).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    tmask, tg = torch.from_numpy(mask), _t(g)
    out = window_attention_heads(*_views(packed, 3), bt, tmask, 0.25)
    assert out.dtype == BF16
    out.backward(tg)
    q, k, v = _views(packed.detach(), 3)
    _o, ms = heads_attention_bf16_reference(q, k, v, bt.detach(), tmask,
                                            0.25, save_ms=True)
    want = heads_attention_bf16_backward_reference(q, k, v, bt.detach(),
                                                   tmask, ms, tg, 0.25)
    assert packed.grad.dtype == BF16 and bt.grad.dtype == torch.float32
    assert torch.equal(packed.grad, torch.stack(want[:3], dim=2).reshape(
        packed.shape))
    assert torch.equal(bt.grad, want[3])


@pytest.mark.parametrize("b_,nh,hd,window,nw", ATTN_CASES[:3], ids=str)
def test_heads_attention_bf16_check_stages_rebuild_the_twins(b_, nh, hd,
                                                             window, nw):
    """The staged plain versions the card's checks hold the heads kernels
    to, fed the twins' own e and dl, give the twins' out, dq, dk and dv bit
    for bit; the end-to-end slack bounds are non-negative and of the
    outputs' shapes."""
    qkv, bias, mask, g = _attn_inputs(b_, nh, hd, window, nw, b_ + nh)
    q, k, v = _views(_t(qkv), nh)
    g, bias = _t(g), torch.from_numpy(bias)
    tmask = None if mask is None else torch.from_numpy(mask)
    scale = hd ** -0.5
    out, ms = heads_attention_bf16_reference(q, k, v, bias, tmask, scale,
                                             save_ms=True)
    e, dl = bf16_checks.heads_attention_bf16_intermediates(
        q, k, v, bias, tmask, ms, g, scale)
    n = qkv.shape[1]
    assert e.dtype == BF16 and dl.dtype == torch.float32
    assert e.shape == dl.shape == (b_, nh, n, n)
    assert torch.equal(bf16_checks.heads_attention_bf16_fwd_stage(v, ms, e),
                       out)
    want = heads_attention_bf16_backward_reference(q, k, v, bias, tmask, ms,
                                                   g, scale)
    got = bf16_checks.heads_attention_bf16_bwd_stages(q, k, ms, g, e, dl,
                                                      scale)
    for name, p, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(p, w), name
    slack = bf16_checks.heads_attention_bf16_slack(q, k, v, bias, tmask, ms,
                                                   g, scale)
    assert len(slack) == 4
    assert all(t.shape == q.shape and bool((t >= 0).all()) for t in slack)
