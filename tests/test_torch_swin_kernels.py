"""The four Video Swin ops of the port, forward, against the JAX package's
Pallas kernels, on the CPU (their backward: tests/test_torch_swin_backward.py).

The same numpy-seeded inputs go through the JAX function in interpret mode
and through the port's wrapper on CPU tensors, where the wrapper takes its
plain PyTorch version (the CUDA kernels are held against those plain
versions on the card, tests/test_torch_cuda.py and chip_smoke.py).  Sizes
are small and keep the real structure: N = wd*wh*ww with an hw that is no
multiple of 8, several heads, more than one mask window.

Tolerances, and why:
* LayerNorm: 1e-5.  The same one-pass float32 formula; sums in another
  order.
* bias expansion: exact.  Data movement only.
* attention: 2e-5.  float32 dot products and a softmax, summed in another
  order; the row maximum and sum at 1e-5 relative.
* LayerNorm-MLP: 2e-5 on o and y.  The Pallas body's erf is a rational
  approximation with 4e-7 absolute error (pallas_mlp.py:50-62), the port's
  is erf itself; K is at most 64 here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.models.swin import relative_position_index as jax_rpi
from vitta_tpu.ops.pallas_attention import fused_window_attention_packed
from vitta_tpu.ops.pallas_attention import _packed_attn_fwd
from vitta_tpu.ops.pallas_bias import compact_bias as jax_compact_bias
from vitta_tpu.ops.pallas_bias import expand_bias_pallas
from vitta_tpu.ops.pallas_ln import layer_norm_pallas
from vitta_tpu.ops.pallas_mlp import _pallas_lnmlp_fwd, fused_ln_mlp
from vitta_tpu_torch.ops.cuda_attention import window_attention_packed
from vitta_tpu_torch.ops.cuda_bias import compact_bias, expand_bias
from vitta_tpu_torch.ops.cuda_ln import layer_norm
from vitta_tpu_torch.ops.cuda_mlp import ln_mlp

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# --------------------------------------------------------------- LayerNorm
@pytest.mark.parametrize("rows,c", [(16, 128), (24, 256), (8, 96), (40, 8)])
def test_layer_norm_matches_pallas(rows, c):
    rng = np.random.default_rng(rows * 1000 + c)
    x = (rng.normal(size=(rows, c)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=c).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    want = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b), 1e-5, True))
    got = layer_norm(_t(x), _t(g), _t(b), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_norm_takes_any_rank():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 4, 5, 16)).astype(np.float32)
    g, b = np.ones(16, np.float32), np.zeros(16, np.float32)
    got = layer_norm(_t(x), _t(g), _t(b))
    want = torch.nn.functional.layer_norm(_t(x), (16,))
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- bias expansion
@pytest.mark.parametrize("window,nh", [((2, 3, 3), 2), ((3, 2, 5), 4),
                                       ((8, 7, 7), 1)])
def test_bias_expansion_matches_pallas_exactly(window, nh):
    wd, wh, ww = window
    rng = np.random.default_rng(wd * 100 + wh * 10 + ww)
    t4 = rng.normal(size=(2 * wd - 1, 2 * wh - 1, 2 * ww - 1, nh)).astype(
        np.float32)
    want_v = np.asarray(jax_compact_bias(jnp.asarray(t4), window))
    want = np.asarray(expand_bias_pallas(jnp.asarray(t4), window,
                                         interpret=True))
    flat = _t(t4.reshape(-1, nh))      # the reference's flat (R, nh) table
    v = compact_bias(flat, window)
    np.testing.assert_array_equal(v.numpy(), want_v)
    got = expand_bias(v, wd)
    np.testing.assert_array_equal(got.numpy(), want)
    # and both equal the reference's gather table[relative_position_index]
    n = wd * wh * ww
    idx = np.asarray(jax_rpi(window)).reshape(-1)
    gather = t4.reshape(-1, nh)[idx].reshape(n, n, nh).transpose(2, 0, 1)
    np.testing.assert_array_equal(got.numpy(), gather)


# --------------------------------------------------------------- attention
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
    return qkv, vc, mask, wd, nh, hd


@pytest.mark.parametrize("bias_form", ["dense", "compact"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_attention_matches_pallas(with_mask, bias_form):
    qkv, vc, mask, wd, nh, hd = _attn_inputs(with_mask)
    scale = hd ** -0.5
    dense = expand_bias(_t(vc), wd)
    jbias = jnp.asarray(vc if bias_form == "compact" else dense.numpy())
    want = np.asarray(fused_window_attention_packed(
        jnp.asarray(qkv), jbias, None if mask is None else jnp.asarray(mask),
        scale, nh, interpret=True))
    bias = _t(vc) if bias_form == "compact" else dense
    got = window_attention_packed(_t(qkv), bias,
                                  None if mask is None else _t(mask),
                                  scale, nh)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_packed_attention_row_max_and_sum_match_pallas(with_mask):
    qkv, vc, mask, wd, nh, hd = _attn_inputs(with_mask, seed=1)
    scale = hd ** -0.5
    dense = expand_bias(_t(vc), wd)
    jmask = None if mask is None else jnp.asarray(mask).astype(jnp.bfloat16)
    want_o, want_ms = _packed_attn_fwd(jnp.asarray(qkv),
                                       jnp.asarray(dense.numpy()), jmask,
                                       scale, nh, save_ms=True,
                                       interpret=True)
    got_o, got_ms = window_attention_packed(
        _t(qkv), dense, None if mask is None else _t(mask), scale, nh,
        save_ms=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=2e-5,
                               atol=2e-5)
    assert got_ms.shape == (qkv.shape[0], qkv.shape[1], 2 * nh)
    np.testing.assert_allclose(got_ms.numpy(), np.asarray(want_ms),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- LayerNorm-MLP
def _mlp_inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    f = 4 * c
    x = (rng.normal(size=(m, c)) * 1.5).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bt = (0.1 * rng.normal(size=c)).astype(np.float32)
    w1 = (rng.normal(size=(c, f)) / np.sqrt(c)).astype(np.float32)   # JAX layout
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(f, c)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=c)).astype(np.float32)
    return x, g, bt, w1, b1, w2, b2


@pytest.mark.parametrize("m,c", [(16, 128), (24, 16), (8, 8)])
def test_ln_mlp_matches_pallas(m, c):
    x, g, bt, w1, b1, w2, b2 = _mlp_inputs(m, c, seed=m + c)
    want_o, want_y = fused_ln_mlp(*(jnp.asarray(a) for a in
                                    (x, g, bt, w1, b1, w2, b2)), 1e-5,
                                  use_pallas=False, interpret=True)
    got_o, got_y = ln_mlp(_t(x), _t(g), _t(bt), _t(w1.T), _t(b1), _t(w2.T),
                          _t(b2), 1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=2e-5,
                               atol=2e-5)


def test_ln_mlp_residuals_match_pallas():
    x, g, bt, w1, b1, w2, b2 = _mlp_inputs(16, 128, seed=5)
    want = _pallas_lnmlp_fwd(*(jnp.asarray(a) for a in
                               (x, g, bt, w1, b1, w2, b2)), 1e-5, True,
                             interpret=True)
    got = ln_mlp(_t(x), _t(g), _t(bt), _t(w1.T), _t(b1), _t(w2.T), _t(b2),
                 1e-5, save_residuals=True)
    assert len(got) == 4
    for name, a, b in zip(("o", "y", "a", "s"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_ln_mlp_keeps_leading_axes():
    x, g, bt, w1, b1, w2, b2 = _mlp_inputs(24, 16, seed=9)
    o2, y2 = ln_mlp(_t(x), _t(g), _t(bt), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    o5, y5 = ln_mlp(_t(x).reshape(2, 3, 2, 2, 16), _t(g), _t(bt), _t(w1.T),
                    _t(b1), _t(w2.T), _t(b2))
    assert o5.shape == y5.shape == (2, 3, 2, 2, 16)
    torch.testing.assert_close(o5.reshape(24, 16), o2)
    torch.testing.assert_close(y5.reshape(24, 16), y2)


# ------------------------------------------------- CPU backward is autograd
def test_cpu_wrappers_are_differentiable():
    """On CPU tensors the wrappers are plain PyTorch, so autograd works;
    on the card their backward is a kernel (tests/test_torch_cuda.py)."""
    x, g, bt, w1, b1, w2, b2 = _mlp_inputs(8, 8, seed=2)
    xt = _t(x).requires_grad_()
    o, y = ln_mlp(xt, _t(g), _t(bt), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    (o.sum() + y.sum()).backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    xl = _t(x).requires_grad_()
    layer_norm(xl, _t(g), _t(bt)).sum().backward()
    assert xl.grad is not None
