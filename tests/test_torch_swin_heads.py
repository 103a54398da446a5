"""The port's window attention per (head, window)
(vitta_tpu_torch/ops/cuda_attention.py: ``window_attention_heads``,
``attention_reference``, ``heads_attention_backward_reference``), on the
CPU, against the JAX package's ``fused_window_attention`` with its Pallas
kernels in interpret mode (as tests/test_pallas_attention.py runs them) and
against torch autograd through the plain forward, on the same numpy-seeded
inputs, with and without a shift mask.

``heads_attention_backward_reference`` is what the CUDA backward kernel is
held to on the card (tests/test_torch_cuda.py, chip_smoke.py); this file
holds it to the two references that exist without a card.  q, k and v come
as tensors of their own and as the strided views of one packed projection
output that the model hands the op.

Tolerances: forward rtol / atol 1e-5 (tests/test_pallas_attention.py:33);
gradients 2e-4 against the Pallas kernel (:54) and 2e-5 against autograd
(tests/test_torch_swin_backward.py's bound for the packed form: float32
products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import fused_window_attention
from vitta_tpu_torch.ops.cuda_attention import (
    attention_reference, heads_attention_backward_reference,
    packed_attention_backward_reference, packed_attention_reference,
    window_attention_heads, window_attention_packed)

torch.set_num_threads(1)

FWD_TOL, PALLAS_GRAD_TOL, AUTOGRAD_TOL = 1e-5, 2e-4, 2e-5
NAMES = ("dq", "dk", "dv", "dbias")
CASES = [dict(with_mask=False), dict(with_mask=True),
         dict(with_mask=True, b_=4, n=18, nh=3, hd=4, nw=2, seed=1),
         dict(with_mask=False, b_=2, n=45, nh=1, hd=16, seed=2)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _inputs(with_mask, b_=6, n=24, nh=2, hd=8, nw=3, seed=0):
    """(packed qkv (B_, N, 3*nh*hd), bias (nh, N, N), mask or None, the
    cotangent (B_, N, nh, hd)) as numpy arrays."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b_, n, 3 * nh * hd)).astype(np.float32)
    bias = rng.normal(size=(nh, n, n)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0).astype(
            np.float32)
        idx = np.arange(n)
        mask[:, idx, idx] = 0.0         # a token always sees itself
    g = rng.normal(size=(b_, n, nh, hd)).astype(np.float32)
    return qkv, bias, mask, g, nh, hd


def _views(qkv, nh, hd):
    """q, k, v (B_, N, nh, hd) as views of the packed tensor."""
    b_, n, _ = qkv.shape
    return qkv.reshape(b_, n, 3, nh, hd).unbind(2)


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


def _ids(case):
    return "-".join(f"{k}={v}" for k, v in case.items())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_matches_pallas(case):
    qkv, bias, mask, _g, nh, hd = _inputs(**case)
    scale = hd ** -0.5
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in _views(_t(qkv), nh, hd))
    want = fused_window_attention(
        jq, jk, jv, jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), scale, interpret=True)
    q, k, v = _views(_t(qkv), nh, hd)
    assert not q.is_contiguous()
    got = window_attention_heads(q, k, v, _t(bias),
                                 None if mask is None else _t(mask), scale)
    assert got.shape == q.shape
    _close(got, want, FWD_TOL, "out")
    # tensors of their own give the same values as the views
    own = window_attention_heads(q.contiguous(), k.contiguous(),
                                 v.contiguous(), _t(bias),
                                 None if mask is None else _t(mask), scale)
    assert torch.equal(own, got)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_is_the_packed_op_on_the_same_memory(case):
    qkv, bias, mask, _g, nh, hd = _inputs(**case)
    mask_t = None if mask is None else _t(mask)
    got = window_attention_heads(*_views(_t(qkv), nh, hd), _t(bias), mask_t,
                                 hd ** -0.5)
    want = window_attention_packed(_t(qkv), _t(bias), mask_t, hd ** -0.5, nh)
    assert torch.equal(got.reshape(want.shape), want)


def _plain_backward(qkv, bias, mask, g, nh, hd):
    q, k, v = _views(_t(qkv), nh, hd)
    return heads_attention_backward_reference(
        q, k, v, _t(bias), None if mask is None else _t(mask), _t(g),
        hd ** -0.5)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_backward_matches_autograd(case):
    qkv, bias, mask, g, nh, hd = _inputs(**case)
    got = _plain_backward(qkv, bias, mask, g, nh, hd)
    ins = [t.contiguous().requires_grad_() for t in _views(_t(qkv), nh, hd)]
    ins.append(_t(bias).requires_grad_())
    out = attention_reference(*ins, None if mask is None else _t(mask),
                              hd ** -0.5)
    want = torch.autograd.grad(out, ins, _t(g))
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        _close(a, w, AUTOGRAD_TOL, name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_backward_matches_pallas(case):
    qkv, bias, mask, g, nh, hd = _inputs(**case)
    jmask = None if mask is None else jnp.asarray(mask)
    jins = [jnp.asarray(t.numpy()) for t in _views(_t(qkv), nh, hd)]
    _, vjp = jax.vjp(
        lambda q, k, v, b: fused_window_attention(q, k, v, b, jmask,
                                                  hd ** -0.5, interpret=True),
        *jins, jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    got = _plain_backward(qkv, bias, mask, g, nh, hd)
    for name, a, w in zip(NAMES, got, want):
        _close(a, w, PALLAS_GRAD_TOL, name)


@pytest.mark.parametrize("with_mask", [False, True])
def test_backward_rebuilds_what_the_packed_form_saves(with_mask):
    """The packed form reads the row maximum and sum its forward kept, this
    one rebuilds them from q and k: the same gradients."""
    qkv, bias, mask, g, nh, hd = _inputs(with_mask)
    mask_t = None if mask is None else _t(mask)
    dq, dk, dv, dbias = _plain_backward(qkv, bias, mask, g, nh, hd)
    _out, ms = packed_attention_reference(_t(qkv), _t(bias), mask_t,
                                          hd ** -0.5, nh, save_ms=True)
    b_, n, c3 = qkv.shape
    dqkv, dbias_p = packed_attention_backward_reference(
        _t(qkv), _t(bias), mask_t, ms, _t(g).reshape(b_, n, c3 // 3),
        hd ** -0.5, nh)
    _close(torch.stack([dq, dk, dv], dim=2).reshape(b_, n, c3), dqkv, 1e-6,
           "dqkv")
    _close(dbias, dbias_p, 1e-6, "dbias")


def test_gradients_through_the_op_reach_the_packed_tensor():
    """Under autograd on strided views, with the loss of
    tests/test_pallas_attention.py:38: the gradient of the packed tensor
    the views were taken from, against the Pallas kernel's dq, dk, dv."""
    qkv, bias, mask, _g, nh, hd = _inputs(True)
    scale = hd ** -0.5

    def jloss(q, k, v, b):
        out = fused_window_attention(q, k, v, b, jnp.asarray(mask), scale,
                                     interpret=True)
        return jnp.sum(out * jnp.sin(out))

    jins = [jnp.asarray(t.numpy()) for t in _views(_t(qkv), nh, hd)]
    dq, dk, dv, dbias = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *jins, jnp.asarray(bias))
    packed = _t(qkv).requires_grad_()
    bias_t = _t(bias).requires_grad_()
    out = window_attention_heads(*_views(packed, nh, hd), bias_t, _t(mask),
                                 scale)
    got = torch.autograd.grad((out * torch.sin(out)).sum(), [packed, bias_t])
    want = np.stack([np.asarray(t) for t in (dq, dk, dv)], axis=2).reshape(
        qkv.shape)
    _close(got[0], want, PALLAS_GRAD_TOL, "dqkv")
    _close(got[1], dbias, PALLAS_GRAD_TOL, "dbias")
