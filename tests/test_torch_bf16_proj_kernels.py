"""The bfloat16 forms of the projection-fused window attention (PERF.md rows
16-19: ``attn_proj`` and ``attn_ln_proj``, forward and backward) against
vitta_tpu's Pallas kernels at bfloat16 (_proj_attn_fwd, _proj_attn_bwd,
_proj_ln_attn_fwd, _proj_ln_attn_bwd, vitta_tpu/ops/pallas_attention.py:
724-1016), on the CPU.

The same numpy-seeded inputs, rounded to bfloat16 once, go through the
Pallas kernel in interpret mode (as vitta_tpu's own tests run them) and
through the port's plain version, the twin its CUDA kernels are held to on
the card (tests/test_torch_cuda.py, chip_smoke.py).  Weights are passed in
each package's layout (the port's nn.Linear (out, in), vitta_tpu's (in,
out)); the bias dense (nh, N, N) float32, the mask 0 / -100.  Each backward
takes vitta_tpu's forward residuals (o_att and ms, and y under the
LayerNorm) in both packages.

The TPU kernels keep qkv, g_att and dqkv inside; each is rebuilt outside
the kernel the way the kernel makes it (qkv = jnp.dot at bfloat16 plus the
bfloat16 bias, g_att = g wproj^T then ``.astype``, dqkv by vitta_tpu's
packed backward kernel on them, the kernels' shared head loop), and the
test asserts that each rebuilt one gives the kernel's next output bit for
bit (o_att, dx).  The port's steps are then held on those intermediates.

Tolerances: those of tests/test_torch_bf16_swin_t_kernels.py and of the
card's checks (vitta_tpu_torch/tools/bf16_checks.py), for the same reasons.
A bfloat16 output within one bfloat16 ulp of vitta_tpu's or a floor of its
tensor's largest magnitude: ``DIRECT`` (2^-20) where both round one float32
value of the same rounded inputs (the two projections' rounded products,
g_att, dx, the weight and bias gradients, the LayerNorm's y and dx), with
at most ``MAX_APART`` (1%) of the values an ulp apart; the Dense step that
adds the bfloat16 bias to the rounded product, from vitta_tpu's own
product, bit for bit.  The attention's o_att and dqkv, made from the
rounded e and dl, end to end as the card holds them
(``bf16_checks.assert_bf16_mostly_within``: at most 1e-4 of the values
beyond one ulp or 2^-12 of the largest magnitude, and those within 2^-7 of
the absolute products through e and dl).  ms at rtol 1e-5 / atol 1e-6;
dbias, dgamma and dbeta (float32) to 1e-5 of their largest value.

dbias is held to vitta_tpu's packed backward kernel run on the rebuilt qkv
and g_att (the projection-fused kernels' own head loop, ``_heads_bwd``),
whose dbias lies within 2.2e-7 of its largest value of the float64 sum of
dl over the windows; the projection-fused backward kernel's own dbias, in
interpret mode, lies up to 1.8e-5 of it away at 12 of the 648 values of
the first case (XLA:CPU compiles the interpret program as one, and drops
bfloat16 roundings inside it: PERF.md section 6).

``test_single_rounding_dense_misses_direct`` shows why the plain versions
round the product before the bias: one rounding of product plus bias, as
``F.linear`` at bfloat16 makes it, misses ``DIRECT`` on qkv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_swin_kernels import (BF16, DIRECT, MAX_APART,
                                                _assert_rel, _assert_ulp,
                                                _jbf16, _t)
from vitta_tpu.ops.pallas_attention import (_packed_attn_bwd,
                                            _packed_attn_fwd, _proj_attn_bwd,
                                            _proj_attn_fwd,
                                            _proj_ln_attn_bwd,
                                            _proj_ln_attn_fwd)
from vitta_tpu_torch.ops.cuda_attention import (
    packed_attention_bf16_backward_reference, packed_attention_bf16_reference)
from vitta_tpu_torch.ops.cuda_attention_proj import (
    dense_bf16, ln_proj_attention_bf16_backward_reference,
    ln_proj_attention_bf16_reference, proj_attention_bf16_backward_reference,
    proj_attention_bf16_reference, window_attention_ln_proj,
    window_attention_proj)
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
from vitta_tpu_torch.ops.cuda_ln import (layer_norm_backward_reference,
                                         layer_norm_reference)
from vitta_tpu_torch.tools import bf16_checks

torch.set_num_threads(1)

EPS = 1e-5
# (B_, nh, hd, window, nW): nh 2 to 4, hd 16 and 32, with and without the
# shift mask
CASES = [(8, 2, 16, (2, 3, 3), 4), (4, 4, 32, (2, 3, 3), 0),
         (2, 3, 32, (4, 7, 7), 2), (4, 4, 16, (2, 3, 3), 2)]
PROJ_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
LN_NAMES = ("dx", "dgamma", "dbeta") + PROJ_NAMES[1:]
_F32 = jnp.float32


def _inputs(b_, nh, hd, window, nw, seed):
    """numpy / JAX inputs: x, the LayerNorm's gamma and beta, the weights
    in vitta_tpu's (in, out) layout and their biases (of the products'
    size, so that the Dense step's second rounding matters), the dense
    bias, the mask or None, the cotangents g and gy."""
    wd, wh, ww = window
    n, c = wd * wh * ww, nh * hd
    rng = np.random.default_rng(seed)
    vc = rng.normal(size=(nh, 2 * wd - 1, wh * ww, wh * ww)) * 0.5
    bias = expand_bias_reference(torch.tensor(vc, dtype=torch.float32),
                                 wd).numpy()
    mask = None
    if nw:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
        mask[:, np.arange(n), np.arange(n)] = 0.0
        mask = mask.astype(np.float32)
    return dict(
        x=_jbf16(rng.normal(size=(b_, n, c)) * 1.5 + 0.3),
        gamma=jnp.asarray(1 + 0.1 * rng.normal(size=c), _F32),
        beta=jnp.asarray(0.1 * rng.normal(size=c), _F32),
        w=_jbf16(rng.normal(size=(c, 3 * c)) / np.sqrt(c)),
        b=_jbf16(0.5 * rng.normal(size=3 * c)),
        wp=_jbf16(rng.normal(size=(c, c)) / np.sqrt(c)),
        bp=_jbf16(0.5 * rng.normal(size=c)),
        bias=bias, mask=mask,
        g=_jbf16(rng.normal(size=(b_, n, c))),
        gy=_jbf16(0.3 * rng.normal(size=(b_, n, c))))


def _jmask(p):
    """The mask as vitta_tpu hands its kernels: bfloat16 (0 and -100 are
    exact)."""
    return None if p["mask"] is None else jnp.asarray(p["mask"]).astype(
        jnp.bfloat16)


def _port(p):
    """The port's tensors: x, wqkv (3C, C), bqkv, wproj (C, C), bproj, the
    dense bias, the mask."""
    return (_t(p["x"]), _t(p["w"]).t().contiguous(), _t(p["b"]),
            _t(p["wp"]).t().contiguous(), _t(p["bp"]),
            torch.from_numpy(p["bias"]),
            None if p["mask"] is None else torch.from_numpy(p["mask"]))


def _dot(a, w, dims):
    return jax.lax.dot_general(a, w, (dims, ((), ())),
                               preferred_element_type=_F32)


def _jax_dense(a, w, b):
    """vitta_tpu's Dense step as its kernels make it: the bfloat16 product,
    then the bfloat16 bias (pallas_attention.py:732)."""
    prod = _dot(a, w, ((2,), (0,))).astype(jnp.bfloat16)
    return prod, prod + b


def _hold_dense(name, a, w, b, prod_jax, want):
    """The port's Dense step: its rounded product within DIRECT of
    vitta_tpu's, and from vitta_tpu's product its sum with the bias bit for
    bit; vitta_tpu's whole output within the card's Dense bound of the
    port's (``bf16_checks.assert_dense_within``)."""
    c = a.shape[-1]
    prod = (a.reshape(-1, c).float() @ w.float().t()).to(BF16)
    _assert_ulp(f"{name} product", prod.reshape(*a.shape[:-1], -1), prod_jax,
                DIRECT)
    step = (_t(prod_jax).float() + b.float()).to(BF16)
    assert torch.equal(step, _t(want)), name
    bf16_checks.assert_dense_within(name, _t(want), a, w, b)


def _hold_attention(name, got, want, slack):
    apart = bf16_checks.assert_bf16_mostly_within(name, got, _t(want), slack)
    print(f"{name}: {apart[0]:.2e} of values an ulp apart, {apart[3]:.2e} "
          "beyond it")
    assert apart[0] <= MAX_APART, (name, apart)


def _forward_steps(p, qkv_j, o_att, ms, nh, scale):
    """vitta_tpu's qkv rebuilt outside its kernel, asserted to give the
    kernel's o_att bit for bit through vitta_tpu's packed forward kernel
    (the same head loop); returns it."""
    o_j, ms_j = _packed_attn_fwd(qkv_j, jnp.asarray(p["bias"]), _jmask(p),
                                 scale, nh, save_ms=True, interpret=True)
    assert bool((o_j == o_att).all())
    np.testing.assert_array_equal(np.asarray(ms_j), np.asarray(ms))
    return qkv_j


@pytest.mark.parametrize("b_,nh,hd,window,nw", CASES, ids=str)
def test_proj_bf16_matches_pallas(b_, nh, hd, window, nw):
    p = _inputs(b_, nh, hd, window, nw, b_ * 10 + nh * hd)
    scale = hd ** -0.5
    n = p["x"].shape[1]
    out, o_att, ms = _proj_attn_fwd(
        p["x"], p["w"], p["b"].reshape(1, -1), p["wp"],
        p["bp"].reshape(1, -1), jnp.asarray(p["bias"]), _jmask(p), scale, nh,
        save_res=True, interpret=True)
    assert out.dtype == o_att.dtype == jnp.bfloat16 and ms.dtype == _F32
    prod_j, qkv_j = _jax_dense(p["x"], p["w"], p["b"])
    _forward_steps(p, qkv_j, o_att, ms, nh, scale)
    x, wqkv, bqkv, wproj, bproj, bias, mask = _port(p)
    # the forward's steps: qkv, the attention on vitta_tpu's qkv, out from
    # vitta_tpu's o_att
    _hold_dense("qkv", x, wqkv, bqkv, prod_j, qkv_j)
    got_o, got_ms = packed_attention_bf16_reference(_t(qkv_j), bias, mask,
                                                    scale, nh, save_ms=True)
    np.testing.assert_allclose(got_ms.numpy(), np.asarray(ms), rtol=1e-5,
                               atol=1e-6)
    g = _t(p["g"])
    _hold_attention("o_att", got_o, o_att,
                    bf16_checks.packed_attention_bf16_slack(
                        _t(qkv_j), bias, mask, got_ms, g, scale, nh)[0])
    prod_o, _out = _jax_dense(o_att, p["wp"], p["bp"])
    _hold_dense("out", _t(o_att), wproj, bproj, prod_o, out)
    # the whole forward, the model's entry on the CPU
    res = proj_attention_bf16_reference(x, wqkv, bqkv, wproj, bproj, bias,
                                        mask, scale, nh, True)
    assert torch.equal(window_attention_proj(x, wqkv, bqkv, wproj, bproj,
                                             bias, mask, scale, nh), res[0])
    assert [t.dtype for t in res] == [BF16, BF16, BF16, torch.float32]
    # the backward from vitta_tpu's residuals
    dx, dw, db, dwp, dbp, dbias = _proj_attn_bwd(
        p["x"], p["w"], p["b"].reshape(1, -1), p["wp"],
        jnp.asarray(p["bias"]), _jmask(p), o_att, ms, p["g"], scale, nh,
        interpret=True)
    bf = jnp.bfloat16
    g_att_j = _dot(p["g"], p["wp"], ((2,), (1,))).astype(bf)
    dqkv_j, dbias_j = _packed_attn_bwd(qkv_j, jnp.asarray(p["bias"]),
                                       _jmask(p), ms, g_att_j, scale, nh,
                                       interpret=True)
    # the rebuilt dqkv gives the kernel's dx bit for bit
    assert bool((_dot(dqkv_j, p["w"], ((2,), (1,))).astype(bf) == dx).all())
    steps = bf16_checks.proj_bwd_stages(x, wqkv, wproj, _t(o_att), g, None,
                                        _t(dqkv_j))
    _assert_ulp("g_att", steps["g_att"], g_att_j, DIRECT)
    got_dqkv, got_dbias = packed_attention_bf16_backward_reference(
        _t(qkv_j), bias, mask, _t(ms), _t(g_att_j), scale, nh)
    _hold_attention("dqkv", got_dqkv, dqkv_j,
                    bf16_checks.packed_attention_bf16_slack(
                        _t(qkv_j), bias, mask, _t(ms), _t(g_att_j), scale,
                        nh)[1])
    _assert_rel("dbias", got_dbias, dbias_j, 1e-5)
    for name, theirs in (("dx", dx), ("dwqkv", dw.T.astype(bf)),
                         ("dbqkv", db[0].astype(bf)),
                         ("dwproj", dwp.T.astype(bf)),
                         ("dbproj", dbp[0].astype(bf))):
        _assert_ulp(name, steps[name], theirs, DIRECT)
    # the plain backward is those steps on its own intermediates
    want = proj_attention_bf16_backward_reference(x, res[1], wqkv, wproj,
                                                  bias, mask, res[2], res[3],
                                                  g, scale, nh)
    assert [t.dtype for t in want] == [BF16] * 5 + [torch.float32]
    assert want[0].shape == (b_, n, nh * hd) and want[5].shape == (nh, n, n)


@pytest.mark.parametrize("with_gy", [True, False], ids=["gy", "no_gy"])
@pytest.mark.parametrize("b_,nh,hd,window,nw", CASES, ids=str)
def test_ln_proj_bf16_matches_pallas(b_, nh, hd, window, nw, with_gy):
    p = _inputs(b_, nh, hd, window, nw, b_ * 7 + nh * hd + 1)
    scale = hd ** -0.5
    out, y, o_att, ms = _proj_ln_attn_fwd(
        p["x"], p["gamma"].reshape(1, -1), p["beta"].reshape(1, -1), p["w"],
        p["b"].reshape(1, -1), p["wp"], p["bp"].reshape(1, -1),
        jnp.asarray(p["bias"]), _jmask(p), EPS, scale, nh, save_res=True,
        interpret=True)
    assert y.dtype == out.dtype == jnp.bfloat16
    x, wqkv, bqkv, wproj, bproj, bias, mask = _port(p)
    gamma, beta = _t(p["gamma"]), _t(p["beta"])
    _assert_ulp("y", layer_norm_reference(x, gamma, beta, EPS), y, DIRECT)
    prod_j, qkv_j = _jax_dense(y, p["w"], p["b"])
    _forward_steps(p, qkv_j, o_att, ms, nh, scale)
    _hold_dense("qkv", _t(y), wqkv, bqkv, prod_j, qkv_j)
    prod_o, _out = _jax_dense(o_att, p["wp"], p["bp"])
    _hold_dense("out", _t(o_att), wproj, bproj, prod_o, out)
    res = ln_proj_attention_bf16_reference(x, gamma, beta, EPS, wqkv, bqkv,
                                           wproj, bproj, bias, mask, scale,
                                           nh, True)
    got = window_attention_ln_proj(x, gamma, beta, EPS, wqkv, bqkv, wproj,
                                   bproj, bias, mask, scale, nh)
    assert torch.equal(got[0], res[0]) and torch.equal(got[1], res[1])
    # the backward from vitta_tpu's residuals, with and without gy
    gy = p["gy"] if with_gy else jnp.zeros_like(p["gy"])
    dx, dg, dbt, dw, db, dwp, dbp, dbias = _proj_ln_attn_bwd(
        p["x"], p["gamma"].reshape(1, -1), p["beta"].reshape(1, -1), p["w"],
        p["b"].reshape(1, -1), p["wp"], jnp.asarray(p["bias"]), _jmask(p),
        o_att, ms, p["g"], gy, EPS, scale, nh, interpret=True)
    bf = jnp.bfloat16
    g_att_j = _dot(p["g"], p["wp"], ((2,), (1,))).astype(bf)
    dqkv_j, dbias_j = _packed_attn_bwd(qkv_j, jnp.asarray(p["bias"]),
                                       _jmask(p), ms, g_att_j, scale, nh,
                                       interpret=True)
    g = _t(p["g"])
    tgy = _t(p["gy"]) if with_gy else None
    steps = bf16_checks.proj_bwd_stages(_t(y), wqkv, wproj, _t(o_att), g,
                                        tgy, _t(dqkv_j))
    c = x.shape[-1]
    gx, gg, gb = layer_norm_backward_reference(
        x.reshape(-1, c), gamma, steps["dy"].reshape(-1, c), EPS)
    # dy stays float32: dx from it within DIRECT, dgamma and dbeta 1e-5
    _assert_ulp("dx", gx.to(BF16).reshape(x.shape), dx, DIRECT)
    _assert_rel("dgamma", gg, dg, 1e-5)
    _assert_rel("dbeta", gb, dbt, 1e-5)
    _assert_ulp("g_att", steps["g_att"], g_att_j, DIRECT)
    for name, theirs in (("dwqkv", dw.T.astype(bf)),
                         ("dbqkv", db[0].astype(bf)),
                         ("dwproj", dwp.T.astype(bf)),
                         ("dbproj", dbp[0].astype(bf))):
        _assert_ulp(name, steps[name], theirs, DIRECT)
    _assert_rel("dbias", packed_attention_bf16_backward_reference(
        _t(qkv_j), bias, mask, _t(ms), _t(g_att_j), scale, nh)[1], dbias_j,
        1e-5)
    del dbias
    want = ln_proj_attention_bf16_backward_reference(
        x, res[1], res[2], gamma, EPS, wqkv, wproj, bias, mask, res[3],
        res[4], g, tgy, scale, nh)
    assert [t.dtype for t in want] == ([BF16] + [torch.float32] * 2
                                       + [BF16] * 4 + [torch.float32])


def test_single_rounding_dense_misses_direct():
    """One rounding of product plus bias, as ``F.linear`` at bfloat16 makes
    it (``EPI_BIAS``, right for the MLP), misses ``DIRECT`` against
    vitta_tpu's qkv, where the Dense step rounds the product first: a few
    percent of the values lie an ulp or more apart (more than
    ``MAX_APART``), and the card's Dense bound (at most ``DENSE_APART`` of
    the values apart) refuses it too.  The product rounded before the bias
    meets both."""
    p = _inputs(8, 2, 16, (2, 3, 3), 4, 3)
    _prod, qkv_j = _jax_dense(p["x"], p["w"], p["b"])
    x, wqkv, bqkv = _port(p)[:3]
    once = torch.nn.functional.linear(x, wqkv, bqkv)
    assert once.dtype == BF16
    apart = float((once != _t(qkv_j)).float().mean())
    print(f"qkv rounded once: {apart:.2e} of values apart")
    assert apart > MAX_APART
    with pytest.raises(AssertionError):
        _assert_ulp("qkv, rounded once", once, qkv_j, DIRECT)
    with pytest.raises(AssertionError):
        bf16_checks.assert_dense_within("qkv, rounded once", once, x, wqkv,
                                        bqkv)
    twice = dense_bf16(x, wqkv, bqkv)
    assert float((twice != _t(qkv_j)).float().mean()) <= MAX_APART
    bf16_checks.assert_dense_within("qkv, rounded twice", twice, x, wqkv,
                                    bqkv)


def _leaves(p, ln):
    x, wqkv, bqkv, wproj, bproj, bias, mask = _port(p)
    head = [x, _t(p["gamma"]), _t(p["beta"])] if ln else [x]
    leaves = [t.requires_grad_() for t in head + [wqkv, bqkv, wproj, bproj,
                                                  bias]]
    return leaves, mask


@pytest.mark.parametrize("ln", [False, True], ids=["proj", "ln_proj"])
def test_bf16_autograd_is_the_backward_twin(ln):
    """On the CPU a bfloat16 x under autograd runs the plain backward
    (``ProjAttentionPlain``, ``LnProjAttentionPlain``): every gradient
    exactly the twin's, bfloat16 but dgamma, dbeta and dbias."""
    p = _inputs(4, 2, 16, (2, 3, 3), 2, 11)
    leaves, mask = _leaves(p, ln)
    g, gy = _t(p["g"]), _t(p["gy"])
    scale, nh = 0.25, 2
    if ln:
        out, y = window_attention_ln_proj(leaves[0], leaves[1], leaves[2],
                                          EPS, *leaves[3:], mask, scale, nh)
        torch.autograd.backward([out, y], [g, gy])
    else:
        out = window_attention_proj(*leaves, mask, scale, nh)
        out.backward(g)
    assert out.dtype == BF16
    plain = [t.detach() for t in leaves]
    if ln:
        res = ln_proj_attention_bf16_reference(plain[0], plain[1], plain[2],
                                               EPS, *plain[3:], mask, scale,
                                               nh, True)
        want = ln_proj_attention_bf16_backward_reference(
            plain[0], res[1], res[2], plain[1], EPS, plain[3], plain[5],
            plain[7], mask, res[3], res[4], g, gy, scale, nh)
    else:
        res = proj_attention_bf16_reference(*plain, mask, scale, nh, True)
        want = proj_attention_bf16_backward_reference(
            plain[0], res[1], plain[1], plain[3], plain[5], mask, res[2],
            res[3], g, scale, nh)
        want = (want[0],) + want[1:]
    order = ((0, 1, 2, 3, 4, 5, 6, 7) if ln else (0, 1, 2, 3, 4, 5))
    for leaf, i in zip(leaves, order):
        assert torch.equal(leaf.grad, want[i]), i
        assert leaf.grad.dtype == (torch.float32 if leaf.dtype != BF16
                                   else BF16)


@pytest.mark.parametrize("ln", [False, True], ids=["proj", "ln_proj"])
def test_bf16_check_stages_rebuild_the_twins(ln):
    """The staged plain versions the card's checks hold the kernels to
    (tools/bf16_checks.py), fed the twins' own qkv, o_att, g_att and dqkv,
    give the twins' outputs bit for bit."""
    p = _inputs(8, 2, 16, (2, 3, 3), 4, 21)
    x, wqkv, bqkv, wproj, bproj, bias, mask = _port(p)
    g, gy = _t(p["g"]), (_t(p["gy"]) if ln else None)
    gamma = _t(p["gamma"])
    scale, nh = 0.25, 2
    if ln:
        out, y, qkv, o_att, ms = ln_proj_attention_bf16_reference(
            x, gamma, _t(p["beta"]), EPS, wqkv, bqkv, wproj, bproj, bias,
            mask, scale, nh, True)
    else:
        out, qkv, o_att, ms = proj_attention_bf16_reference(
            x, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh, True)
        y = x
    f_qkv, f_out = bf16_checks.proj_fwd_stages(y, wqkv, bqkv, wproj, bproj,
                                               o_att)
    assert torch.equal(f_qkv, qkv) and torch.equal(f_out, out)
    g_att = (g.float() @ wproj.float()).to(BF16)
    dqkv, dbias = packed_attention_bf16_backward_reference(
        qkv, bias, mask, ms, g_att, scale, nh)
    steps = bf16_checks.proj_bwd_stages(y, wqkv, wproj, o_att, g, gy, dqkv)
    assert torch.equal(steps["g_att"], g_att)
    if ln:
        want = ln_proj_attention_bf16_backward_reference(
            x, y, qkv, gamma, EPS, wqkv, wproj, bias, mask, o_att, ms, g, gy,
            scale, nh)
        c = x.shape[-1]
        gx, gg, gb = layer_norm_backward_reference(
            x.reshape(-1, c), gamma, steps["dy"].reshape(-1, c), EPS)
        got = dict(dx=gx.to(BF16).reshape(x.shape), dgamma=gg, dbeta=gb)
        names = LN_NAMES
    else:
        want = proj_attention_bf16_backward_reference(
            x, qkv, wqkv, wproj, bias, mask, o_att, ms, g, scale, nh)
        got = dict(dx=steps["dx"])
        names = PROJ_NAMES
    got.update({k: steps[k] for k in ("dwqkv", "dbqkv", "dwproj",
                                      "dbproj")}, dbias=dbias)
    for name, w in zip(names, want):
        assert torch.equal(got[name], w), name
