"""The projection-fused window attention ops of the port, with and without
the LayerNorm prologue, on the CPU: the plain forward and backward versions
of vitta_tpu_torch/ops/cuda_attention_proj.py against (a) the JAX package's
Pallas kernels in interpret mode (``fused_window_attention_proj`` and
``fused_window_attention_ln_proj``, as tests/test_pallas_attention.py runs
them) and (b) torch autograd through the plain forward, on the same
numpy-seeded inputs and cotangents.

The plain backward versions are what the CUDA backward kernels are held to
on the card (tests/test_torch_cuda.py, chip_smoke.py); this file holds them,
fed the qkv (and y) that the forward keeps, to the two references that
exist without a card, which recompute both.  Sizes are small and keep
the real structure: windows (2, 3, 3) and (3, 2, 5), so N = 18 and 30 with
an hw (9, 10) that is no multiple of 8; 2 to 4 heads; C = 24, 16 and 32,
no multiple of 128; more than one mask window.

Tolerances, and why (those of tests/test_pallas_attention.py or tighter):
* forward, out and y: 2e-5.  The same float32 formulas; products over C
  terms and the softmax over N keys are summed in another order.
* gradients: 1e-4 against the Pallas kernels (their own tests allow 4e-4
  and 6e-4), 5e-5 against autograd.  dW, db, dWp, dbp and dbias are sums
  over all windows and rows; the plain version rebuilds the softmax from
  the saved row maximum and sum, the Pallas kernel from its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import (fused_window_attention_ln_proj,
                                            fused_window_attention_proj)
from vitta_tpu_torch.ops.cuda_attention_proj import (
    ln_proj_attention_backward_reference, ln_proj_attention_reference,
    proj_attention_backward_reference, proj_attention_reference,
    window_attention_ln_proj, window_attention_proj)
from vitta_tpu_torch.ops.cuda_bias import expand_bias

torch.set_num_threads(1)

FWD_TOL = 2e-5
PALLAS_GRAD_TOL = 1e-4
AUTOGRAD_TOL = 5e-5
EPS = 1e-5

# window, heads, head dim, windows, mask windows
CASES = {
    "w233_nh3": ((2, 3, 3), 3, 8, 6, 3),
    "w325_nh2": ((3, 2, 5), 2, 8, 4, 2),
    "w233_nh4": ((2, 3, 3), 4, 8, 4, 4),
}
PROJ_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
LN_NAMES = ("dx", "dgamma", "dbeta") + PROJ_NAMES[1:]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


def _inputs(case, with_mask, seed=0):
    """Numpy inputs in the port's layout: weights as ``nn.Linear`` keeps
    them, (3C, C) and (C, C); the JAX side takes their transposes."""
    (wd, wh, ww), nh, hd, b_, nw = CASES[case]
    rng = np.random.default_rng(seed + 17 * len(case))
    n, hw, c = wd * wh * ww, wh * ww, nh * hd

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    d = dict(
        x=normal(b_, n, c, scale=1.5) + 0.3,
        gamma=1.0 + normal(c, scale=0.1), beta=normal(c, scale=0.05),
        wqkv=normal(3 * c, c, scale=c ** -0.5), bqkv=normal(3 * c, scale=0.1),
        wproj=normal(c, c, scale=c ** -0.5), bproj=normal(c, scale=0.1),
        bias=expand_bias(_t(normal(nh, 2 * wd - 1, hw, hw)), wd).numpy(),
        g=normal(b_, n, c, scale=0.2), gy=normal(b_, n, c, scale=0.2),
        mask=None)
    if with_mask:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0).astype(
            np.float32)
        idx = np.arange(n)
        mask[:, idx, idx] = 0.0         # a token always sees itself
        d["mask"] = mask
    d.update(nh=nh, scale=hd ** -0.5)
    return d


def _torch_args(d):
    w = tuple(_t(d[k]) for k in ("wqkv", "bqkv", "wproj", "bproj"))
    mask = None if d["mask"] is None else _t(d["mask"])
    return _t(d["x"]), w, _t(d["bias"]), mask


def _jax_mask(d):
    return None if d["mask"] is None else jnp.asarray(d["mask"])


def _jax_proj(d, ln):
    """The Pallas op in interpret mode as a function of its differentiable
    inputs, in the JAX package's (in, out) weight layout."""
    mask = _jax_mask(d)
    if ln:
        return lambda x, gm, bt, w, b, wp, bp, bias: \
            fused_window_attention_ln_proj(x, gm, bt, EPS, w, b, wp, bp, bias,
                                           mask, d["scale"], d["nh"],
                                           interpret=True)
    return lambda x, w, b, wp, bp, bias: fused_window_attention_proj(
        x, w, b, wp, bp, bias, mask, d["scale"], d["nh"], interpret=True)


def _jax_inputs(d, ln):
    names = (("x", "gamma", "beta") if ln else ("x",)) + (
        "wqkv", "bqkv", "wproj", "bproj", "bias")
    return [jnp.asarray(d[k].T if k in ("wqkv", "wproj") else d[k])
            for k in names]


def _to_port_layout(grads, ln):
    """The Pallas gradients with the two weight gradients transposed back."""
    grads = [np.asarray(g) for g in grads]
    off = 3 if ln else 1
    grads[off], grads[off + 2] = grads[off].T, grads[off + 2].T
    return grads


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_proj_forward_matches_pallas(case, with_mask):
    d = _inputs(case, with_mask)
    want = _jax_proj(d, False)(*_jax_inputs(d, False))
    x, w, bias, mask = _torch_args(d)
    got = window_attention_proj(x, *w, bias, mask, d["scale"], d["nh"])
    assert got.shape == x.shape
    _close(got, want, FWD_TOL, "out")


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_ln_proj_forward_matches_pallas(case, with_mask):
    d = _inputs(case, with_mask, seed=1)
    want, want_y = _jax_proj(d, True)(*_jax_inputs(d, True))
    x, w, bias, mask = _torch_args(d)
    got, y = window_attention_ln_proj(x, _t(d["gamma"]), _t(d["beta"]), EPS,
                                      *w, bias, mask, d["scale"], d["nh"])
    _close(y, want_y, FWD_TOL, "y")
    _close(got, want, FWD_TOL, "out")


def test_residuals_are_those_of_the_packed_op():
    """qkv, o_att and ms are what the backward reads: qkv is the qkv
    projection of x (of y in the LayerNorm form), o_att and ms the packed
    attention's output and row statistics at it; out follows from o_att."""
    d = _inputs("w233_nh3", True, seed=2)
    x, w, bias, mask = _torch_args(d)
    out, qkv, o_att, ms = proj_attention_reference(
        x, *w, bias, mask, d["scale"], d["nh"], save_residuals=True)
    assert qkv.shape == x.shape[:2] + (3 * x.shape[2],)
    assert o_att.shape == x.shape
    assert ms.shape == (x.shape[0], x.shape[1], 2 * d["nh"])
    _close(qkv, torch.nn.functional.linear(x, w[0], w[1]), 0, "qkv")
    _close(out, torch.nn.functional.linear(o_att, w[2], w[3]), 1e-6, "out")
    res = ln_proj_attention_reference(x, _t(d["gamma"]), _t(d["beta"]), EPS,
                                      *w, bias, mask, d["scale"], d["nh"],
                                      save_residuals=True)
    assert len(res) == 5 and res[3].shape == x.shape
    _close(res[2], torch.nn.functional.linear(res[1], w[0], w[1]), 0, "qkv")


# ----------------------------------------------------------------- backward
def _plain_proj_backward(d):
    """The plain backward fed what the plain forward kept."""
    x, w, bias, mask = _torch_args(d)
    _out, qkv, o_att, ms = proj_attention_reference(
        x, *w, bias, mask, d["scale"], d["nh"], save_residuals=True)
    return proj_attention_backward_reference(
        x, qkv, w[0], w[2], bias, mask, o_att, ms, _t(d["g"]), d["scale"],
        d["nh"])


def _plain_ln_proj_backward(d, with_gy):
    """The plain backward fed what the plain forward kept, y among it."""
    x, w, bias, mask = _torch_args(d)
    gm, bt = _t(d["gamma"]), _t(d["beta"])
    _out, y, qkv, o_att, ms = ln_proj_attention_reference(
        x, gm, bt, EPS, *w, bias, mask, d["scale"], d["nh"],
        save_residuals=True)
    return ln_proj_attention_backward_reference(
        x, y, qkv, gm, EPS, w[0], w[2], bias, mask, o_att, ms, _t(d["g"]),
        _t(d["gy"]) if with_gy else None, d["scale"], d["nh"])


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_proj_backward_matches_pallas(case, with_mask):
    d = _inputs(case, with_mask, seed=3)
    _, vjp = jax.vjp(_jax_proj(d, False), *_jax_inputs(d, False))
    want = _to_port_layout(vjp(jnp.asarray(d["g"])), False)
    got = _plain_proj_backward(d)
    for name, a, b in zip(PROJ_NAMES, got, want):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, PALLAS_GRAD_TOL, name)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_proj_backward_matches_autograd(case, with_mask):
    d = _inputs(case, with_mask, seed=4)
    x, w, bias, mask = _torch_args(d)
    ins = [t.requires_grad_() for t in (x, *w, bias)]
    out = window_attention_proj(*ins, mask, d["scale"], d["nh"])
    want = torch.autograd.grad(out, ins, _t(d["g"]))
    got = _plain_proj_backward(d)
    for name, a, b in zip(PROJ_NAMES, got, want):
        _close(a, b, AUTOGRAD_TOL, name)


@pytest.mark.parametrize("with_gy", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_ln_proj_backward_matches_pallas(case, with_mask, with_gy):
    d = _inputs(case, with_mask, seed=5)
    _, vjp = jax.vjp(_jax_proj(d, True), *_jax_inputs(d, True))
    gy = d["gy"] if with_gy else np.zeros_like(d["gy"])
    want = _to_port_layout(vjp((jnp.asarray(d["g"]), jnp.asarray(gy))), True)
    got = _plain_ln_proj_backward(d, with_gy)
    for name, a, b in zip(LN_NAMES, got, want):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, PALLAS_GRAD_TOL, name)


@pytest.mark.parametrize("with_gy", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_ln_proj_backward_matches_autograd(case, with_mask, with_gy):
    d = _inputs(case, with_mask, seed=6)
    x, w, bias, mask = _torch_args(d)
    ins = [t.requires_grad_()
           for t in (x, _t(d["gamma"]), _t(d["beta"]), *w, bias)]
    out, y = window_attention_ln_proj(ins[0], ins[1], ins[2], EPS, *ins[3:],
                                      mask, d["scale"], d["nh"])
    outs, cots = ([out, y], [_t(d["g"]), _t(d["gy"])]) if with_gy \
        else ([out], [_t(d["g"])])
    want = torch.autograd.grad(outs, ins, cots)
    got = _plain_ln_proj_backward(d, with_gy)
    for name, a, b in zip(LN_NAMES, got, want):
        _close(a, b, AUTOGRAD_TOL, name)


def test_only_the_tap_cotangent():
    """A loss that reads y alone: the attention's cotangent is zero and dx,
    dgamma, dbeta are the LayerNorm's own backward."""
    d = _inputs("w325_nh2", True, seed=7)
    d["g"] = np.zeros_like(d["g"])
    got = _plain_ln_proj_backward(d, True)
    ins = [_t(d[k]).requires_grad_() for k in ("x", "gamma", "beta")]
    from vitta_tpu_torch.ops.cuda_ln import layer_norm
    want = torch.autograd.grad(layer_norm(*ins, EPS), ins, _t(d["gy"]))
    for name, a, b in zip(LN_NAMES[:3], got, want):
        _close(a, b, AUTOGRAD_TOL, name)
    for name, a in zip(LN_NAMES[3:], got[3:]):
        assert float(a.abs().max()) == 0.0, name


def test_mask_period_does_not_enter_the_weight_gradients():
    """dW, db and dbias are plain sums over all windows, whatever b mod nW
    is: window by window with its own mask slot gives the same sums."""
    d = _inputs("w233_nh3", True, seed=8)
    whole = _plain_proj_backward(d)
    parts = []
    for b in range(d["x"].shape[0]):
        one = dict(d, x=d["x"][b:b + 1], g=d["g"][b:b + 1],
                   mask=d["mask"][b % 3:b % 3 + 1])
        parts.append(_plain_proj_backward(one))
    for i, name in enumerate(PROJ_NAMES[1:], start=1):
        _close(whole[i], torch.stack([p[i] for p in parts]).sum(0),
               AUTOGRAD_TOL, name)


@pytest.mark.parametrize("op", ["proj", "ln_proj"])
def test_a_device_without_an_implementation_raises(op):
    d = _inputs("w233_nh3", False)
    x, w, bias, _mask = _torch_args(d)
    x = x.to("meta")
    with pytest.raises(ValueError, match="no projection-fused window "
                                         "attention for device"):
        if op == "proj":
            window_attention_proj(x, *w, bias, None, d["scale"], d["nh"])
        else:
            window_attention_ln_proj(x, _t(d["gamma"]), _t(d["beta"]), EPS,
                                     *w, bias, None, d["scale"], d["nh"])
