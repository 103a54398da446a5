"""The port's MLP without the LayerNorm prologue
(vitta_tpu_torch/ops/cuda_mlp.py: ``mlp``, ``mlp_reference``,
``mlp_backward_reference``), on the CPU, against the JAX package's
``fused_mlp`` with its Pallas kernels in interpret mode (as
tests/test_pallas_mlp.py runs them) and against torch autograd through the
plain forward, on the same numpy-seeded inputs.

``mlp_backward_reference`` is what the CUDA backward kernel is held to on
the card (tests/test_torch_cuda.py, chip_smoke.py); this file holds it to
the two references that exist without a card.  Widths are those the Video
Swin block sends here (no multiple of 128: 96 as in Swin-T, and smaller),
rows fill more than one Pallas row block.

Tolerances: forward rtol / atol 1e-5 (the same float32 formula; the Pallas
body's erf is a rational approximation with 4e-7 absolute error); gradients
2e-4 against the Pallas kernels (s carries that erf's error into every
gradient, and the weight gradients sum it over up to 2056 rows) and 3e-5
against autograd (tests/test_torch_swin_backward.py's bound for the
LayerNorm form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_mlp import fused_mlp
from vitta_tpu_torch.ops.cuda_mlp import (mlp, mlp_backward_reference,
                                          mlp_reference)

torch.set_num_threads(1)

SHAPES = [(16, 96), (24, 16), (40, 8), (2056, 24)]
FWD_TOL, PALLAS_GRAD_TOL, AUTOGRAD_TOL = 1e-5, 2e-4, 3e-5
NAMES = ("dx", "dw1", "db1", "dw2", "db2")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _inputs(m, c):
    """(x, w1 (F, C), b1, w2 (C, F), b2), cotangent: nn.Linear layouts."""
    rng = np.random.default_rng(m * 100 + c)
    f = 4 * c
    x = (rng.normal(size=(m, c)) * 0.8).astype(np.float32)
    w1 = (rng.normal(size=(f, c)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(c, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=(m, c)).astype(np.float32)
    return (x, w1, b1, w2, b2), g


def _jax_args(params):
    """The JAX package keeps Dense kernels as (in, out)."""
    x, w1, b1, w2, b2 = params
    return [jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2)]


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("m,c", SHAPES)
def test_mlp_matches_pallas(m, c):
    params, _g = _inputs(m, c)
    want = fused_mlp(*_jax_args(params), use_pallas=False, interpret=True)
    got = mlp(*(_t(a) for a in params))
    assert got.shape == (m, c)
    _close(got, want, FWD_TOL, "o")


def test_mlp_keeps_leading_axes():
    params, _g = _inputs(24, 16)
    ts = [_t(a) for a in params]
    o2 = mlp(*ts)
    o5 = mlp(ts[0].reshape(2, 3, 2, 2, 16), *ts[1:])
    assert o5.shape == (2, 3, 2, 2, 16)
    assert torch.equal(o5.reshape(24, 16), o2)


def test_mlp_residuals_are_the_gelu_and_its_derivative():
    params, _g = _inputs(24, 16)
    x, w1, b1, w2, b2 = (_t(a) for a in params)
    o, a, s = mlp(x.reshape(2, 12, 16), w1, b1, w2, b2, save_residuals=True)
    assert o.shape == (2, 12, 16) and a.shape == s.shape == (24, 64)
    assert torch.equal(o.reshape(24, 16), mlp_reference(x, w1, b1, w2, b2))
    h = (x @ w1.t() + b1).requires_grad_()
    act = torch.nn.functional.gelu(h)
    _close(a, act.detach(), 1e-6, "a")
    _close(s, torch.autograd.grad(act.sum(), h)[0], 1e-6, "s")


def _plain_backward(params, g):
    x, w1, b1, w2, b2 = (_t(a) for a in params)
    _o, a, s = mlp(x, w1, b1, w2, b2, save_residuals=True)
    return mlp_backward_reference(x, a, s, _t(g), w1, w2)


@pytest.mark.parametrize("m,c", SHAPES)
def test_mlp_backward_matches_autograd(m, c):
    params, g = _inputs(m, c)
    got = _plain_backward(params, g)
    ins = [_t(a).requires_grad_() for a in params]
    want = torch.autograd.grad(mlp(*ins), ins, _t(g))
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        _close(a, w, AUTOGRAD_TOL, name)


@pytest.mark.parametrize("m,c", SHAPES)
def test_mlp_backward_matches_pallas(m, c):
    params, g = _inputs(m, c)
    _, vjp = jax.vjp(lambda *a: fused_mlp(*a, use_pallas=False,
                                          interpret=True), *_jax_args(params))
    want = list(vjp(jnp.asarray(g)))
    want[1], want[3] = want[1].T, want[3].T
    got = _plain_backward(params, g)
    for name, a, w in zip(NAMES, got, want):
        _close(a, w, PALLAS_GRAD_TOL, name)


def test_gradients_through_the_op_match_pallas():
    """The op under autograd, with the loss of tests/test_pallas_mlp.py:31."""
    params, _g = _inputs(16, 96)

    def jloss(*a):
        out = fused_mlp(*a, use_pallas=False, interpret=True)
        return jnp.sum(out * jnp.cos(out))

    want = list(jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_jax_args(params)))
    want[1], want[3] = want[1].T, want[3].T
    ins = [_t(a).requires_grad_() for a in params]
    out = mlp(*ins)
    got = torch.autograd.grad((out * torch.cos(out)).sum(), ins)
    for name, a, w in zip(NAMES, got, want):
        _close(a, w, PALLAS_GRAD_TOL, name)


def test_no_graph_without_a_gradient():
    params, _g = _inputs(24, 16)
    ins = [_t(a).requires_grad_() for a in params]
    with torch.no_grad():
        assert mlp(*ins).grad_fn is None
    assert mlp(*ins).grad_fn is not None
