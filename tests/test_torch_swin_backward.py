"""The plain backward versions of the four Video Swin ops, on the CPU,
against (a) torch autograd through the op's plain forward and (b) the JAX
package's Pallas backward kernel in interpret mode, on the same
numpy-seeded inputs and cotangents.

The plain backward versions are what the CUDA backward kernels are held to
on the card (tests/test_torch_cuda.py, chip_smoke.py); this file holds them
to the two references that exist without a card.  Sizes are small and keep
the real structure: N = wd*wh*ww with an hw that is no multiple of 8,
several heads, more than one mask window, rows that fill more than one
Pallas row block.

Tolerances, and why:
* LayerNorm: 2e-5.  The same formulas in float32; the weight gradients are
  sums over up to 40 rows taken in another order.
* bias collapse: exact against the Pallas kernel (both add the blocks of a
  block diagonal in the order of the block row) and against autograd to
  1e-6 (index_add in another order).
* LayerNorm-MLP: 3e-5, tests/test_pallas_mlp.py's bound: the Pallas body's
  erf is a rational approximation with 4e-7 absolute error, which enters s
  and, through it, every gradient.
* attention: 2e-5.  The softmax is rebuilt from the saved row maximum and
  sum; float32 products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import fused_window_attention_packed
from vitta_tpu.ops.pallas_bias import assemble_dense
from vitta_tpu.ops.pallas_ln import layer_norm_pallas
from vitta_tpu.ops.pallas_mlp import fused_ln_mlp
from vitta_tpu_torch.ops.cuda_attention import (
    packed_attention_backward_reference, window_attention_packed)
from vitta_tpu_torch.ops.cuda_bias import (collapse_bias_reference,
                                           expand_bias)
from vitta_tpu_torch.ops.cuda_ln import (layer_norm,
                                         layer_norm_backward_reference)
from vitta_tpu_torch.ops.cuda_mlp import ln_mlp, ln_mlp_backward_reference

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


# --------------------------------------------------------------- LayerNorm
LN_SHAPES = [(16, 128), (24, 256), (40, 8)]
LN_TOL = 2e-5


def _ln_inputs(rows, c):
    rng = np.random.default_rng(rows * 1000 + c)
    x = (rng.normal(size=(rows, c)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=c).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    dy = rng.normal(size=(rows, c)).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("rows,c", LN_SHAPES)
def test_layer_norm_backward_matches_autograd(rows, c):
    x, g, b, dy = _ln_inputs(rows, c)
    got = layer_norm_backward_reference(_t(x), _t(g), _t(dy), 1e-5)
    ins = [_t(a).requires_grad_() for a in (x, g, b)]
    want = torch.autograd.grad(layer_norm(*ins, 1e-5), ins, _t(dy))
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        _close(a, w, LN_TOL, name)


@pytest.mark.parametrize("rows,c", LN_SHAPES)
def test_layer_norm_backward_matches_pallas(rows, c):
    x, g, b, dy = _ln_inputs(rows, c)
    _, vjp = jax.vjp(lambda *a: layer_norm_pallas(*a, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    got = layer_norm_backward_reference(_t(x), _t(g), _t(dy), 1e-5)
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        _close(a, w, LN_TOL, name)


# ----------------------------------------------------------- bias collapse
BIAS_CASES = [((2, 3, 3), 2), ((3, 2, 5), 4), ((8, 7, 7), 1)]


def _bias_inputs(window, nh):
    wd, wh, ww = window
    rng = np.random.default_rng(wd * 100 + wh * 10 + ww)
    hw = wh * ww
    v = rng.normal(size=(nh, 2 * wd - 1, hw, hw)).astype(np.float32)
    db = rng.normal(size=(nh, wd * hw, wd * hw)).astype(np.float32)
    return v, db, wd


@pytest.mark.parametrize("window,nh", BIAS_CASES)
def test_bias_collapse_matches_autograd(window, nh):
    v, db, wd = _bias_inputs(window, nh)
    vt = _t(v).requires_grad_()
    want, = torch.autograd.grad(expand_bias(vt, wd), vt, _t(db))
    _close(collapse_bias_reference(_t(db), wd), want, 1e-6, "dV")


@pytest.mark.parametrize("window,nh", BIAS_CASES)
def test_bias_collapse_matches_pallas_exactly(window, nh):
    v, db, wd = _bias_inputs(window, nh)
    _, vjp = jax.vjp(lambda a: assemble_dense(a, wd, interpret=True),
                     jnp.asarray(v))
    want, = vjp(jnp.asarray(db))
    got = collapse_bias_reference(_t(db), wd)
    assert got.shape == v.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- LayerNorm-MLP
MLP_SHAPES = [(16, 128), (24, 16), (8, 8)]
MLP_TOL = 3e-5


def _mlp_inputs(m, c, with_gy):
    rng = np.random.default_rng(m * 100 + c)
    f = 4 * c
    x = (rng.normal(size=(m, c)) * 1.5).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bt = (0.1 * rng.normal(size=c)).astype(np.float32)
    w1 = (rng.normal(size=(f, c)) / np.sqrt(c)).astype(np.float32)  # (F, C)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(c, f)) / np.sqrt(f)).astype(np.float32)  # (C, F)
    b2 = (0.1 * rng.normal(size=c)).astype(np.float32)
    go = rng.normal(size=(m, c)).astype(np.float32)
    gy = rng.normal(size=(m, c)).astype(np.float32) if with_gy else None
    return (x, g, bt, w1, b1, w2, b2), go, gy


def _mlp_plain_backward(params, go, gy):
    x, g, bt, w1, b1, w2, b2 = (_t(a) for a in params)
    _o, y, a, s = ln_mlp(x, g, bt, w1, b1, w2, b2, 1e-5, save_residuals=True)
    return ln_mlp_backward_reference(x, y, a, s, _t(go),
                                     None if gy is None else _t(gy), g, w1,
                                     w2, 1e-5)


MLP_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("with_gy", [True, False])
@pytest.mark.parametrize("m,c", MLP_SHAPES)
def test_ln_mlp_backward_matches_autograd(m, c, with_gy):
    params, go, gy = _mlp_inputs(m, c, with_gy)
    got = _mlp_plain_backward(params, go, gy)
    ins = [_t(a).requires_grad_() for a in params]
    o, y = ln_mlp(*ins, 1e-5)
    outs, cots = [o], [_t(go)]
    if with_gy:
        outs.append(y)
        cots.append(_t(gy))
    want = torch.autograd.grad(outs, ins, cots)
    for name, a, w in zip(MLP_NAMES, got, want):
        _close(a, w, MLP_TOL, name)


@pytest.mark.parametrize("with_gy", [True, False])
@pytest.mark.parametrize("m,c", MLP_SHAPES)
def test_ln_mlp_backward_matches_pallas(m, c, with_gy):
    params, go, gy = _mlp_inputs(m, c, with_gy)
    x, g, bt, w1, b1, w2, b2 = params
    # the JAX package keeps Dense kernels as (in, out)
    jargs = [jnp.asarray(a) for a in (x, g, bt, w1.T, b1, w2.T, b2)]
    _, vjp = jax.vjp(lambda *a: fused_ln_mlp(*a, 1e-5, use_pallas=False,
                                             interpret=True), *jargs)
    want = list(vjp((jnp.asarray(go),
                     jnp.asarray(np.zeros_like(go) if gy is None else gy))))
    want[3], want[5] = want[3].T, want[5].T
    got = _mlp_plain_backward(params, go, gy)
    for name, a, w in zip(MLP_NAMES, got, want):
        _close(a, w, MLP_TOL, name)


# --------------------------------------------------------------- attention
ATTN_TOL = 2e-5


def _attn_inputs(with_mask, b_=6, nh=3, hd=8, wd=2, wh=3, ww=3, nw=3, seed=0):
    rng = np.random.default_rng(seed)
    n, hw = wd * wh * ww, wh * ww        # N = 18, hw = 9: no multiple of 8
    qkv = rng.normal(size=(b_, n, 3 * nh * hd)).astype(np.float32)
    vc = rng.normal(size=(nh, 2 * wd - 1, hw, hw)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0).astype(
            np.float32)
        idx = np.arange(n)
        mask[:, idx, idx] = 0.0         # a token always sees itself
    g = rng.normal(size=(b_, n, nh * hd)).astype(np.float32)
    return qkv, vc, mask, g, wd, nh, hd


def _attn_plain_backward(qkv, bias, mask, g, scale, nh):
    mask_t = None if mask is None else _t(mask)
    _out, ms = window_attention_packed(_t(qkv), bias, mask_t, scale, nh,
                                       save_ms=True)
    return packed_attention_backward_reference(_t(qkv), bias, mask_t, ms,
                                               _t(g), scale, nh)


@pytest.mark.parametrize("bias_form", ["dense", "compact"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_attention_backward_matches_autograd(with_mask, bias_form):
    qkv, vc, mask, g, wd, nh, hd = _attn_inputs(with_mask)
    scale = hd ** -0.5
    bias = _t(vc) if bias_form == "compact" else expand_bias(_t(vc), wd)
    dqkv, dbias = _attn_plain_backward(qkv, bias, mask, g, scale, nh)
    ins = [_t(qkv).requires_grad_(), bias.clone().requires_grad_()]
    out = window_attention_packed(ins[0], ins[1],
                                  None if mask is None else _t(mask), scale,
                                  nh)
    want = torch.autograd.grad(out, ins, _t(g))
    assert dbias.shape == bias.shape
    _close(dqkv, want[0], ATTN_TOL, "dqkv")
    _close(dbias, want[1], ATTN_TOL, "dbias")


@pytest.mark.parametrize("bias_form", ["dense", "compact"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_attention_backward_matches_pallas(with_mask, bias_form):
    qkv, vc, mask, g, wd, nh, hd = _attn_inputs(with_mask, seed=1)
    scale = hd ** -0.5
    dense = expand_bias(_t(vc), wd)
    bias = _t(vc) if bias_form == "compact" else dense
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda a, b: fused_window_attention_packed(a, b, jmask, scale, nh,
                                                   interpret=True),
        jnp.asarray(qkv), jnp.asarray(bias.numpy()))
    want_dqkv, want_dbias = vjp(jnp.asarray(g))
    dqkv, dbias = _attn_plain_backward(qkv, bias, mask, g, scale, nh)
    assert dbias.shape == bias.shape
    _close(dqkv, want_dqkv, ATTN_TOL, "dqkv")
    _close(dbias, want_dbias, ATTN_TOL, "dbias")


def test_mask_period_does_not_enter_the_bias_gradient():
    """The windows of one mask slot are not grouped: dbias is the plain sum
    over all windows, whatever b mod nW is."""
    qkv, vc, mask, g, wd, nh, hd = _attn_inputs(True, seed=2)
    bias = expand_bias(_t(vc), wd)
    _dqkv, dbias = _attn_plain_backward(qkv, bias, mask, g, hd ** -0.5, nh)
    parts = [_attn_plain_backward(qkv[b:b + 1], bias, mask[b % 3:b % 3 + 1],
                                  g[b:b + 1], hd ** -0.5, nh)[1]
             for b in range(qkv.shape[0])]
    _close(dbias, torch.stack(parts).sum(0), ATTN_TOL, "dbias")
