"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so that it runs on the card's machine, which has none:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances are
tests/test_pallas_tam.py's: forward 1e-5, gradients 2e-4; the kernel sums
dattn and dK in another order than the plain version's autograd.  The
Video Swin forward kernels: LayerNorm 1e-5; bias expansion exact;
attention 2e-5 (``__expf`` and another summation order); LayerNorm-MLP
rtol 1e-4 / atol 1e-4 (tiled float32 sums over up to 4096 terms).  Their
backward kernels against the plain backward versions: every gradient to
2e-5 of its tensor's largest magnitude (``GRAD_REL``: the sums over rows or
windows are taken in chunks and the chunks added in order, not in the
plain version's order; float32 throughout, the attention's products in
split TF32), the bias collapse exactly.
The projection-fused attention kernels: forward rtol 1e-4 / atol 1e-4 as
the LayerNorm-MLP (two tiled float32 products around the attention's
softmax); every gradient to 5e-5 of its tensor's largest magnitude
(``PROJ_GRAD_REL``: four tiled products and the recomputed qkv in the chain,
where the LayerNorm-MLP backward has two).  The MLP without the LayerNorm
and the attention per (head, window) are held to the bounds of the
LayerNorm-MLP and of the packed attention.  The BatchNorm-statistics
kernels: y and the mean rtol / atol 1e-5, the variance rtol 1e-4 / atol 1e-5
(tests/test_pallas_stats.py's: ``E[y^2] - m^2`` from sums taken in another
order), every gradient to 2e-5 of its tensor's largest magnitude.
"""

import numpy as np
import pytest
import torch

from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                 cuda_bias, cuda_ln, cuda_mlp, cuda_stats,
                                 cuda_tam)
from vitta_tpu_torch.ops.cuda_tam import (tam_dynamic_conv,
                                          tam_dynamic_conv_reference)
from vitta_tpu_torch.tools.synthetic import device_breakdown

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-5, 2e-4
SHAPES = [dict(), dict(t=3), dict(h=16), dict(n=1, t=16, h=7, w=7, c=64),
          dict(n=2, t=16, h=14, w=14, c=256), dict(c=30, w=5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, n=2, t=5, h=8, w=4, c=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, h, w, c)).astype(np.float32)
    attn = 1.0 / (1.0 + np.exp(-rng.normal(size=(n, t, c))))
    logits = rng.normal(size=(n, c, 3))
    kernel = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (x, attn, kernel, cot)]


def _value_and_grads(fn, x, attn, kernel, cot):
    ts = [v.clone().requires_grad_() for v in (x, attn, kernel)]
    out = fn(*ts)
    out.backward(cot)
    return [out.detach()] + [t.grad for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: str(s or "base"))
def test_kernel_matches_plain(cuda_device, shape):
    x, attn, kernel, cot = _inputs(cuda_device, **shape)
    cuda_tam.counters.reset()
    got = _value_and_grads(tam_dynamic_conv, x, attn, kernel, cot)
    assert (cuda_tam.counters.fwd, cuda_tam.counters.bwd) == (1, 1)
    want = _value_and_grads(tam_dynamic_conv_reference, x, attn, kernel, cot)
    for g, w, name, tol in zip(got, want, ("out", "dx", "dattn", "dkernel"),
                               (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)


@pytest.mark.cuda
def test_kernel_rejects_bfloat16_and_strided_input(cuda_device):
    x, attn, kernel, _ = _inputs(cuda_device)
    with pytest.raises(TypeError):
        tam_dynamic_conv(x.bfloat16(), attn, kernel)
    with pytest.raises(ValueError):
        tam_dynamic_conv(x.transpose(2, 3), attn, kernel)


@pytest.mark.cuda
def test_strided_gradient_is_copied_and_counted(cuda_device):
    x, attn, kernel, cot = _inputs(cuda_device, h=4)
    cuda_tam.counters.reset()
    xs = x.clone().requires_grad_()
    out = tam_dynamic_conv(xs, attn, kernel)
    # the same values in transposed memory: a non-contiguous cotangent
    strided = cot.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    out.backward(strided)
    assert cuda_tam.counters.grad_copies == 1
    ref = x.clone().requires_grad_()
    tam_dynamic_conv_reference(ref, attn, kernel).backward(cot)
    torch.testing.assert_close(xs.grad, ref.grad, rtol=GRAD_TOL, atol=GRAD_TOL)


# --------------------------------------------------------------------------
# Video Swin forward kernels
def _randn(device, *shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(392, 128), (1000, 256), (77, 512),
                                    (33, 1024), (9, 2048), (50, 96), (7, 8)])
def test_ln_kernel_matches_plain(cuda_device, rows, c):
    x = _randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5
    g, b = _randn(cuda_device, c, seed=2), _randn(cuda_device, c, seed=3)
    cuda_ln.counters.reset()
    got = cuda_ln.layer_norm(x, g, b, 1e-5)
    assert cuda_ln.counters.fwd == 1
    want = cuda_ln.layer_norm_reference(x, g, b, 1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("window,nh", [((8, 7, 7), 4), ((2, 3, 3), 2),
                                       ((3, 2, 5), 32)])
def test_bias_kernel_matches_plain_exactly(cuda_device, window, nh):
    wd, wh, ww = window
    table = _randn(cuda_device,
                   (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), nh, seed=4)
    v = cuda_bias.compact_bias(table, window)
    cuda_bias.counters.reset()
    got = cuda_bias.expand_bias(v, wd)
    assert cuda_bias.counters.fwd == 1
    assert torch.equal(got, cuda_bias.expand_bias_reference(v, wd))


def _attn_case(device, b_, nh, hd, window, nw, seed=0):
    wd, wh, ww = window
    n, hw = wd * wh * ww, wh * ww
    qkv = _randn(device, b_, n, 3 * nh * hd, seed=seed)
    vc = _randn(device, nh, 2 * wd - 1, hw, hw, seed=seed + 1)
    mask = None
    if nw:
        rng = np.random.default_rng(seed + 2)
        m = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
        m[:, np.arange(n), np.arange(n)] = 0.0
        mask = torch.tensor(m, dtype=torch.float32, device=device)
    return qkv, vc, mask, wd


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", [
    dict(b_=8, nh=4, hd=32, window=(8, 7, 7), nw=4),
    dict(b_=2, nh=32, hd=32, window=(8, 7, 7), nw=0),
    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3),
    dict(b_=4, nh=1, hd=8, window=(2, 3, 3), nw=0)], ids=str)
def test_attention_kernel_matches_plain(cuda_device, case, compact):
    qkv, vc, mask, wd = _attn_case(cuda_device, **case)
    nh, hd = case["nh"], case["hd"]
    bias = vc if compact else cuda_bias.expand_bias_reference(vc, wd)
    cuda_attention.counters.reset()
    got, ms = cuda_attention.window_attention_packed(
        qkv, bias, mask, hd ** -0.5, nh, save_ms=True)
    assert cuda_attention.counters.fwd == 1
    want, want_ms = cuda_attention.packed_attention_reference(
        qkv, bias, mask, hd ** -0.5, nh, save_ms=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(ms, want_ms, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(392, 1024), (1568, 512), (500, 128),
                                 (130, 256), (37, 64), (9, 8)])
def test_ln_mlp_kernel_matches_plain(cuda_device, m, c):
    f = 4 * c
    x = _randn(cuda_device, m, c, seed=1, scale=1.5)
    g = 1 + 0.1 * _randn(cuda_device, c, seed=2)
    bt = 0.1 * _randn(cuda_device, c, seed=3)
    w1 = _randn(cuda_device, f, c, seed=4, scale=c ** -0.5)
    b1 = 0.1 * _randn(cuda_device, f, seed=5)
    w2 = _randn(cuda_device, c, f, seed=6, scale=f ** -0.5)
    b2 = 0.1 * _randn(cuda_device, c, seed=7)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cuda_mlp.counters.reset()
        got = cuda_mlp.ln_mlp(x, g, bt, w1, b1, w2, b2, 1e-5,
                              save_residuals=True)
        assert cuda_mlp.counters.fwd == 1
        want = cuda_mlp.ln_mlp_reference(x, g, bt, w1, b1, w2, b2, 1e-5,
                                         save_residuals=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, a, b in zip(("o", "y", "a", "s"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


# --------------------------------------------------------------------------
# Video Swin backward kernels
GRAD_REL = 2e-5


def _assert_grad(name, got, want, rel=GRAD_REL):
    """|got - want| <= rel * max|want| everywhere."""
    assert got.shape == want.shape, name
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (
        f"{name}: max abs error {err:.3e} on values up to {scale:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(392, 128), (1000, 256), (777, 512),
                                    (33, 1024), (9, 2048), (50, 96), (7, 8)])
def test_ln_backward_kernel_matches_plain(cuda_device, rows, c):
    x = _randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5
    g, dy = _randn(cuda_device, c, seed=2), _randn(cuda_device, rows, c, seed=3)
    cuda_ln.counters.reset()
    got = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    assert cuda_ln.counters.bwd == 1
    want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        _assert_grad(name, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("window,nh", [((8, 7, 7), 4), ((2, 3, 3), 2),
                                       ((3, 2, 5), 32)])
def test_bias_collapse_kernel_matches_plain_exactly(cuda_device, window, nh):
    wd, wh, ww = window
    n = wd * wh * ww
    db = _randn(cuda_device, nh, n, n, seed=4)
    cuda_bias.counters.reset()
    got = cuda_bias.collapse_bias_cuda(db, wd)
    assert cuda_bias.counters.bwd == 1
    assert torch.equal(got, cuda_bias.collapse_bias_reference(db, wd))


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", [
    dict(b_=8, nh=4, hd=32, window=(8, 7, 7), nw=4),
    dict(b_=2, nh=32, hd=32, window=(8, 7, 7), nw=0),
    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3),
    dict(b_=4, nh=1, hd=24, window=(3, 5, 5), nw=2),
    dict(b_=4, nh=1, hd=8, window=(2, 3, 3), nw=0),
    dict(b_=1, nh=32, hd=32, window=(8, 7, 7), nw=0),
    dict(b_=2, nh=16, hd=32, window=(8, 7, 7), nw=2)], ids=str)
def test_attention_backward_kernel_matches_plain(cuda_device, case, compact):
    qkv, vc, mask, wd = _attn_case(cuda_device, **case)
    nh, hd = case["nh"], case["hd"]
    scale = hd ** -0.5
    bias = vc if compact else cuda_bias.expand_bias_reference(vc, wd)
    g = _randn(cuda_device, qkv.shape[0], qkv.shape[1], nh * hd, seed=9)
    _out, ms = cuda_attention.attn_packed_fwd_cuda(qkv, bias, mask, scale, nh,
                                                   save_ms=True)
    cuda_attention.counters.reset()
    dqkv, dbias = cuda_attention.attn_packed_bwd_cuda(qkv, bias, mask, ms, g,
                                                      scale, nh)
    assert cuda_attention.counters.bwd == 1
    want_dqkv, want_dbias = cuda_attention.packed_attention_backward_reference(
        qkv, bias, mask, ms, g, scale, nh)
    c = nh * hd
    for i, name in enumerate(("dq", "dk", "dv")):
        _assert_grad(name, dqkv[..., i * c:(i + 1) * c],
                     want_dqkv[..., i * c:(i + 1) * c])
    _assert_grad("dbias", dbias, want_dbias)
    # the same from run to run: no atomics anywhere
    again = cuda_attention.attn_packed_bwd_cuda(qkv, bias, mask, ms, g, scale,
                                                nh)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


@pytest.mark.cuda
@pytest.mark.parametrize("b_,nh", [(8, 4), (2, 32), (1, 32)])
def test_attention_backward_launches(cuda_device, b_, nh):
    """One backward call: the kernel, the sum of the blocks' shares of dk
    and dv where a problem is shared (fewer problems than SMs), and the
    sum of dl over the windows; the per-(head, window) form the same, and
    no launch of the forward kernel."""
    ca = cuda_attention
    qkv, vc, _mask, wd = _attn_case(cuda_device, b_, nh, 32, (8, 7, 7), 0)
    bias = cuda_bias.expand_bias_reference(vc, wd)
    g = _randn(cuda_device, b_, 392, nh * 32, seed=9)
    _out, ms = ca.attn_packed_fwd_cuda(qkv, bias, None, 32 ** -0.5, nh,
                                       save_ms=True)
    q, k, v = qkv.reshape(b_, 392, 3, nh, 32).unbind(2)
    want = 2 + (ca.bwd_split(b_, nh, cuda_device) > 1)
    for fn in (lambda: ca.attn_packed_bwd_cuda(qkv, bias, None, ms, g,
                                               32 ** -0.5, nh),
               lambda: ca.attn_heads_bwd_cuda(
                   q, k, v, bias, None, ms, g.reshape(b_, 392, nh, 32),
                   32 ** -0.5)):
        names = {name: launches for name, _ms, launches
                 in device_breakdown(fn, top=None)[2]}
        assert sum(names.values()) == want, names
        assert not any("attn_fwd_kernel" in k for k in names), names
        assert any("attn_bwd_kernel" in k for k in names), names


def _mlp_case(device, m, c):
    f = 4 * c
    return (_randn(device, m, c, seed=1, scale=1.5),
            1 + 0.1 * _randn(device, c, seed=2),
            0.1 * _randn(device, c, seed=3),
            _randn(device, f, c, seed=4, scale=c ** -0.5),
            0.1 * _randn(device, f, seed=5),
            _randn(device, c, f, seed=6, scale=f ** -0.5),
            0.1 * _randn(device, c, seed=7))


MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


@pytest.mark.cuda
@pytest.mark.parametrize("with_gy", [True, False])
@pytest.mark.parametrize("m,c", [(392, 1024), (1568, 512), (5000, 128),
                                 (130, 256), (37, 64), (9, 8)])
def test_ln_mlp_backward_kernel_matches_plain(cuda_device, m, c, with_gy):
    x, g, bt, w1, b1, w2, b2 = _mlp_case(cuda_device, m, c)
    go = _randn(cuda_device, m, c, seed=8)
    gy = _randn(cuda_device, m, c, seed=9) if with_gy else None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _o, y, a, s = cuda_mlp.ln_mlp_fwd_cuda(x, g, bt, w1, b1, w2, b2, 1e-5,
                                               save_residuals=True)
        cuda_mlp.counters.reset()
        got = cuda_mlp.ln_mlp_bwd_cuda(x, y, a, s, go, gy, g, w1, w2, 1e-5)
        assert cuda_mlp.counters.bwd == 1
        want = cuda_mlp.ln_mlp_backward_reference(x, y, a, s, go, gy, g, w1,
                                                  w2, 1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, p, q in zip(MLP_GRADS, got, want):
        _assert_grad(name, p, q)


def _op_case(dev, op):
    """(function of the differentiable inputs -> outputs tuple, its plain
    version, the inputs, the module whose ``bwd`` counter moves)."""
    if op == "ln":
        ins = [_randn(dev, 40, 128, seed=1), _randn(dev, 128, seed=2),
               _randn(dev, 128, seed=3)]
        return (lambda *a: (cuda_ln.layer_norm(*a),),
                lambda *a: (cuda_ln.layer_norm_reference(*a),), ins, cuda_ln)
    if op == "bias":
        ins = [_randn(dev, 2, 3, 9, 9, seed=1)]
        return (lambda v: (cuda_bias.expand_bias(v, 2),),
                lambda v: (cuda_bias.expand_bias_reference(v, 2),), ins,
                cuda_bias)
    if op == "attention":
        qkv, vc, mask, _wd = _attn_case(dev, 6, 3, 8, (2, 3, 3), 3)
        return (lambda a, b: (cuda_attention.window_attention_packed(
                    a, b, mask, 8 ** -0.5, 3),),
                lambda a, b: (cuda_attention.packed_attention_reference(
                    a, b, mask, 8 ** -0.5, 3),), [qkv, vc], cuda_attention)
    ins = list(_mlp_case(dev, 24, 16))
    return (lambda *a: cuda_mlp.ln_mlp(*a),
            lambda *a: cuda_mlp.ln_mlp_reference(*a), ins, cuda_mlp)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ln", "bias", "attention", "ln_mlp"])
def test_swin_ops_differentiate_through_their_kernels(cuda_device, op):
    """``backward`` through the wrapper launches the backward kernel once
    and gives the gradients of autograd through the plain forward, for a
    cotangent on every output."""
    fn, plain, ins, mod = _op_case(cuda_device, op)
    got_in = [t.clone().requires_grad_() for t in ins]
    want_in = [t.clone().requires_grad_() for t in ins]
    mod.counters.reset()
    outs = fn(*got_in)
    cots = [_randn(cuda_device, *o.shape, seed=20 + i)
            for i, o in enumerate(outs)]
    got = torch.autograd.grad(outs, got_in, cots)
    assert (mod.counters.fwd, mod.counters.bwd) == (1, 1)
    want = torch.autograd.grad(plain(*want_in), want_in, cots)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_grad(f"{op} input {i}", a, b)


@pytest.mark.cuda
def test_ln_mlp_backward_without_a_cotangent_on_y(cuda_device):
    ins = [t.requires_grad_() for t in _mlp_case(cuda_device, 24, 16)]
    cuda_mlp.counters.reset()
    o, _y = cuda_mlp.ln_mlp(*ins)
    got = torch.autograd.grad(o.sum(), ins)
    assert cuda_mlp.counters.bwd == 1
    ref = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(cuda_mlp.ln_mlp_reference(*ref)[0].sum(), ref)
    for name, a, b in zip(MLP_GRADS, got, want):
        _assert_grad(name, a, b)


@pytest.mark.cuda
def test_backward_kernels_reject_bf16_and_strided_cotangents(cuda_device):
    dev = cuda_device
    x, g = _randn(dev, 8, 128), _randn(dev, 128)
    dy = _randn(dev, 8, 128, seed=1)
    with pytest.raises(TypeError):
        cuda_ln.ln_bwd_cuda(x, g, dy.bfloat16())
    with pytest.raises(ValueError):
        cuda_ln.ln_bwd_cuda(x, g, _randn(dev, 128, 8).t())
    with pytest.raises(TypeError):
        cuda_bias.collapse_bias_cuda(_randn(dev, 2, 18, 18).bfloat16(), 2)
    with pytest.raises(ValueError):
        cuda_bias.collapse_bias_cuda(_randn(dev, 2, 18, 18).transpose(1, 2), 2)
    qkv, vc, mask, _wd = _attn_case(dev, 6, 3, 8, (2, 3, 3), 3)
    _out, ms = cuda_attention.attn_packed_fwd_cuda(qkv, vc, mask, 8 ** -0.5, 3,
                                                   save_ms=True)
    cot = _randn(dev, 6, 18, 24, seed=2)
    with pytest.raises(TypeError):
        cuda_attention.attn_packed_bwd_cuda(qkv, vc, mask, ms, cot.bfloat16(),
                                            8 ** -0.5, 3)
    with pytest.raises(ValueError):
        cuda_attention.attn_packed_bwd_cuda(
            qkv, vc, mask, ms, _randn(dev, 6, 24, 18).transpose(1, 2),
            8 ** -0.5, 3)
    x, gm, bt, w1, b1, w2, b2 = _mlp_case(dev, 24, 16)
    _o, y, a, s = cuda_mlp.ln_mlp_fwd_cuda(x, gm, bt, w1, b1, w2, b2, 1e-5,
                                           save_residuals=True)
    go = _randn(dev, 24, 16, seed=3)
    with pytest.raises(TypeError):
        cuda_mlp.ln_mlp_bwd_cuda(x, y, a, s, go.bfloat16(), None, gm, w1, w2)
    with pytest.raises(ValueError):
        cuda_mlp.ln_mlp_bwd_cuda(x, y, a, s, go, _randn(dev, 16, 24).t(), gm,
                                 w1, w2)


@pytest.mark.cuda
def test_strided_cotangent_of_a_swin_op_is_copied_and_counted(cuda_device):
    from vitta_tpu_torch.models import swin
    x = _randn(cuda_device, 40, 128, seed=1).requires_grad_()
    g, b = _randn(cuda_device, 128, seed=2), _randn(cuda_device, 128, seed=3)
    cot = _randn(cuda_device, 128, 40, seed=4).t()
    assert not cot.is_contiguous()
    swin.counters.reset()
    cuda_ln.layer_norm(x, g, b).backward(cot)
    assert swin.counters.contiguity_copies == 1
    ref = x.detach().clone().requires_grad_()
    cuda_ln.layer_norm_reference(ref, g, b).backward(cot)
    _assert_grad("dx", x.grad, ref.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ln", "attention", "ln_mlp"])
def test_no_residual_is_saved_under_no_grad(cuda_device, op):
    """Under ``torch.no_grad()`` the ops keep nothing for a backward: no
    graph, and no more memory than their outputs; with a gradient wanted
    the attention and the LayerNorm-MLP hold their residuals."""
    fn, _plain, ins, _mod = _op_case(cuda_device, op)
    ins = [t.requires_grad_() for t in ins]

    def held(grad):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.set_grad_enabled(grad):
            outs = fn(*ins)
        torch.cuda.synchronize()
        extra = (torch.cuda.memory_allocated() - before
                 - sum(o.numel() * 4 for o in outs))
        return outs, extra

    outs, extra = held(False)
    assert all(o.grad_fn is None for o in outs)
    assert extra <= 2048 * len(outs)      # the allocator's rounding only
    outs, extra_grad = held(True)
    assert all(o.grad_fn is not None for o in outs)
    if op != "ln":                        # LayerNorm keeps only its inputs
        assert extra_grad > extra


@pytest.mark.cuda
def test_swin_kernels_reject_what_they_do_not_take(cuda_device):
    dev = cuda_device
    x = _randn(dev, 8, 128)
    g = _randn(dev, 128)
    with pytest.raises(TypeError):
        cuda_ln.layer_norm(x.bfloat16(), g, g)
    with pytest.raises(ValueError):
        cuda_ln.layer_norm(x.t(), g[:8], g[:8])
    with pytest.raises(ValueError):       # hd = 64 > 32
        cuda_attention.window_attention_packed(
            _randn(dev, 2, 18, 3 * 64), _randn(dev, 1, 18, 18), None, 0.125, 1)
    with pytest.raises(ValueError):       # C = 6 is no multiple of 4
        cuda_mlp.ln_mlp(_randn(dev, 4, 6), g[:6], g[:6], _randn(dev, 24, 6),
                        _randn(dev, 24), _randn(dev, 6, 24), g[:6])


# --------------------------------------------------------------------------
# projection-fused window attention, with and without the LayerNorm prologue
PROJ_TOL = 1e-4
PROJ_GRAD_REL = 5e-5
PROJ_CASES = [
    dict(b_=8, nh=4, hd=32, window=(8, 7, 7), nw=4),
    dict(b_=2, nh=32, hd=32, window=(8, 7, 7), nw=0),
    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3),
    dict(b_=4, nh=2, hd=12, window=(3, 2, 5), nw=2),
    dict(b_=4, nh=1, hd=8, window=(2, 3, 3), nw=0)]
PROJ_GRADS = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
LN_PROJ_GRADS = ("dx", "dgamma", "dbeta") + PROJ_GRADS[1:]


@pytest.fixture
def float32_matmul():
    """The plain versions' products in float32, as the kernels' are."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _proj_case(device, b_, nh, hd, window, nw):
    """(x, gamma, beta, (wqkv, bqkv, wproj, bproj), dense bias, mask, scale)."""
    _qkv, vc, mask, wd = _attn_case(device, b_, nh, hd, window, nw)
    c = nh * hd
    n = window[0] * window[1] * window[2]
    w = (_randn(device, 3 * c, c, seed=11, scale=c ** -0.5),
         0.1 * _randn(device, 3 * c, seed=12),
         _randn(device, c, c, seed=13, scale=c ** -0.5),
         0.1 * _randn(device, c, seed=14))
    return (_randn(device, b_, n, c, seed=10, scale=1.5) + 0.3,
            1 + 0.1 * _randn(device, c, seed=15),
            0.1 * _randn(device, c, seed=16), w,
            cuda_bias.expand_bias_reference(vc, wd), mask, hd ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROJ_CASES, ids=str)
def test_attn_proj_kernels_match_plain(cuda_device, float32_matmul, case):
    cp = cuda_attention_proj
    x, _gm, _bt, w, bias, mask, scale = _proj_case(cuda_device, **case)
    nh = case["nh"]
    cp.counters.reset()
    got = cp.attn_proj_fwd(x, *w, bias, mask, scale, nh, save_residuals=True)
    assert cp.counters.proj_fwd == 1
    want = cp.proj_attention_reference(x, *w, bias, mask, scale, nh, True)
    for name, a, b in zip(("out", "o_att", "ms"), got, want):
        torch.testing.assert_close(a, b, rtol=PROJ_TOL, atol=PROJ_TOL,
                                   msg=name)
    torch.testing.assert_close(
        cp.attn_proj_fwd(x, *w, bias, mask, scale, nh), got[0], rtol=0, atol=0)
    _out, o_att, ms = got
    g = _randn(cuda_device, *x.shape, seed=17)
    args = (x, w[0], w[1], w[2], bias, mask, o_att, ms, g, scale, nh)
    grads = cp.attn_proj_bwd(*args)
    assert cp.counters.proj_bwd == 1
    for name, a, b in zip(PROJ_GRADS, grads,
                          cp.proj_attention_backward_reference(*args)):
        _assert_grad(name, a, b, PROJ_GRAD_REL)
    # the same from run to run: no atomics anywhere
    assert all(torch.equal(a, b)
               for a, b in zip(cp.attn_proj_bwd(*args), grads))


@pytest.mark.cuda
@pytest.mark.parametrize("with_gy", [True, False])
@pytest.mark.parametrize("case", PROJ_CASES, ids=str)
def test_attn_ln_proj_kernels_match_plain(cuda_device, float32_matmul, case,
                                          with_gy):
    cp = cuda_attention_proj
    x, gm, bt, w, bias, mask, scale = _proj_case(cuda_device, **case)
    nh = case["nh"]
    cp.counters.reset()
    got = cp.attn_ln_proj_fwd(x, gm, bt, 1e-5, *w, bias, mask, scale, nh,
                              save_residuals=True)
    assert cp.counters.ln_proj_fwd == 1
    want = cp.ln_proj_attention_reference(x, gm, bt, 1e-5, *w, bias, mask,
                                          scale, nh, True)
    for name, a, b in zip(("out", "y", "o_att", "ms"), got, want):
        torch.testing.assert_close(a, b, rtol=PROJ_TOL, atol=PROJ_TOL,
                                   msg=name)
    _out, _y, o_att, ms = got
    g = _randn(cuda_device, *x.shape, seed=17)
    gy = _randn(cuda_device, *x.shape, seed=18) if with_gy else None
    args = (x, gm, bt, 1e-5, w[0], w[1], w[2], bias, mask, o_att, ms, g, gy,
            scale, nh)
    grads = cp.attn_ln_proj_bwd(*args)
    assert cp.counters.ln_proj_bwd == 1
    for name, a, b in zip(LN_PROJ_GRADS, grads,
                          cp.ln_proj_attention_backward_reference(*args)):
        _assert_grad(name, a, b, PROJ_GRAD_REL)
    assert all(torch.equal(a, b)
               for a, b in zip(cp.attn_ln_proj_bwd(*args), grads))


def _proj_op(dev, op, case=PROJ_CASES[2]):
    """(function of the differentiable inputs, its plain version, inputs)."""
    cp = cuda_attention_proj
    x, gm, bt, w, bias, mask, scale = _proj_case(dev, **case)
    nh = case["nh"]
    if op == "proj":
        return (lambda *a: (cp.window_attention_proj(*a, mask, scale, nh),),
                lambda *a: (cp.proj_attention_reference(*a, mask, scale, nh),),
                [x, *w, bias])
    return (lambda a, b, c, *r: cp.window_attention_ln_proj(
                a, b, c, 1e-5, *r, mask, scale, nh),
            lambda a, b, c, *r: cp.ln_proj_attention_reference(
                a, b, c, 1e-5, *r, mask, scale, nh),
            [x, gm, bt, *w, bias])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["proj", "ln_proj"])
def test_proj_ops_differentiate_through_their_kernels(cuda_device,
                                                      float32_matmul, op):
    cp = cuda_attention_proj
    fn, plain, ins = _proj_op(cuda_device, op)
    got_in = [t.clone().requires_grad_() for t in ins]
    want_in = [t.clone().requires_grad_() for t in ins]
    cp.counters.reset()
    outs = fn(*got_in)
    cots = [_randn(cuda_device, *o.shape, seed=20 + i)
            for i, o in enumerate(outs)]
    got = torch.autograd.grad(outs, got_in, cots)
    assert (getattr(cp.counters, f"{op}_fwd"),
            getattr(cp.counters, f"{op}_bwd")) == (1, 1)
    want = torch.autograd.grad(plain(*want_in), want_in, cots)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_grad(f"{op} input {i}", a, b, PROJ_GRAD_REL)


@pytest.mark.cuda
def test_ln_proj_with_a_cotangent_on_one_output_only(cuda_device,
                                                     float32_matmul):
    fn, plain, ins = _proj_op(cuda_device, "ln_proj")
    for which in (0, 1):
        got_in = [t.clone().requires_grad_() for t in ins]
        want_in = [t.clone().requires_grad_() for t in ins]
        got = torch.autograd.grad(fn(*got_in)[which].square().sum(), got_in,
                                  allow_unused=True)
        want = torch.autograd.grad(plain(*want_in)[which].square().sum(),
                                   want_in, allow_unused=True)
        for name, a, b in zip(LN_PROJ_GRADS, got, want):
            if b is None or float(b.abs().max()) == 0.0:
                assert a is None or float(a.abs().max()) == 0.0, name
            else:
                _assert_grad(f"output {which} {name}", a, b, PROJ_GRAD_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["proj", "ln_proj"])
def test_frozen_parameters_get_no_gradient(cuda_device, float32_matmul, op):
    """A parameter that wants no gradient gets None; the others are
    unchanged by its absence."""
    fn, _plain, ins = _proj_op(cuda_device, op)
    full_in = [t.clone().requires_grad_() for t in ins]
    full = torch.autograd.grad(fn(*full_in)[0].square().sum(), full_in)
    frozen = {1, 2, len(ins) - 1} if op == "proj" else {1, 4, len(ins) - 1}
    part_in = [t.clone().requires_grad_(i not in frozen)
               for i, t in enumerate(ins)]
    fn(*part_in)[0].square().sum().backward()
    for i, (t, want) in enumerate(zip(part_in, full)):
        if i in frozen:
            assert t.grad is None, i
        else:
            assert torch.equal(t.grad, want), i


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["proj", "ln_proj"])
def test_proj_ops_save_no_residual_under_no_grad(cuda_device, op):
    fn, _plain, ins = _proj_op(cuda_device, op, PROJ_CASES[0])
    ins = [t.requires_grad_() for t in ins]

    def held(grad):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.set_grad_enabled(grad):
            outs = fn(*ins)
        torch.cuda.synchronize()
        return outs, (torch.cuda.memory_allocated() - before
                      - sum(o.numel() * 4 for o in outs))

    outs, extra = held(False)
    assert all(o.grad_fn is None for o in outs)
    assert extra <= 2048 * len(outs)      # the allocator's rounding only
    outs, extra_grad = held(True)
    assert all(o.grad_fn is not None for o in outs)
    # o_att and ms are kept, qkv is not: less than two activations
    x = ins[0]
    assert x.numel() * 4 <= extra_grad < 2 * x.numel() * 4


@pytest.mark.cuda
def test_strided_cotangent_of_a_proj_op_is_copied_and_counted(cuda_device,
                                                              float32_matmul):
    from vitta_tpu_torch.models import swin
    fn, plain, ins = _proj_op(cuda_device, "proj")
    got_in = [t.clone().requires_grad_() for t in ins]
    want_in = [t.clone().requires_grad_() for t in ins]
    b_, n, c = ins[0].shape
    cot = _randn(cuda_device, b_, c, n, seed=30).transpose(1, 2)
    assert not cot.is_contiguous()
    swin.counters.reset()
    got = torch.autograd.grad(fn(*got_in), got_in, [cot])
    assert swin.counters.contiguity_copies == 1
    want = torch.autograd.grad(plain(*want_in), want_in, [cot])
    for name, a, b in zip(PROJ_GRADS, got, want):
        _assert_grad(name, a, b, PROJ_GRAD_REL)


@pytest.mark.cuda
def test_proj_kernels_reject_what_they_do_not_take(cuda_device):
    cp = cuda_attention_proj
    dev = cuda_device
    x, gm, bt, w, bias, mask, scale = _proj_case(dev, **PROJ_CASES[2])
    with pytest.raises(TypeError):
        cp.window_attention_proj(x.bfloat16(), *w, bias, mask, scale, 3)
    with pytest.raises(ValueError):       # a strided input
        cp.window_attention_proj(x.transpose(0, 1).contiguous().transpose(0, 1),
                                 *w, bias, mask, scale, 3)
    with pytest.raises(ValueError):       # the compact bias form
        cp.window_attention_proj(x, *w, _randn(dev, 3, 3, 9, 9), mask, scale, 3)
    with pytest.raises(ValueError):       # weights in the (in, out) layout
        cp.window_attention_proj(x, w[0].t().contiguous(), *w[1:], bias, mask,
                                 scale, 3)
    with pytest.raises(ValueError):       # hd = 64 > 32
        cp.window_attention_proj(
            _randn(dev, 2, 18, 64), _randn(dev, 192, 64), _randn(dev, 192),
            _randn(dev, 64, 64), _randn(dev, 64), _randn(dev, 1, 18, 18), None,
            0.125, 1)
    with pytest.raises(ValueError):       # 6 windows, 4 mask windows
        cp.window_attention_ln_proj(x, gm, bt, 1e-5, *w, bias,
                                    _randn(dev, 4, 18, 18), scale, 3)
    with pytest.raises(TypeError):
        cp.window_attention_ln_proj(x, gm.double(), bt, 1e-5, *w, bias, mask,
                                    scale, 3)


# --------------------------------------------------------------------------
# the MLP without the LayerNorm, and the attention per (head, window)
PLAIN_MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2")


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(3136, 96), (1568, 192), (500, 384),
                                 (130, 768), (392, 128), (37, 24), (9, 8)])
def test_mlp_kernels_match_plain(cuda_device, float32_matmul, m, c):
    x, _g, _bt, w1, b1, w2, b2 = _mlp_case(cuda_device, m, c)
    cuda_mlp.counters.reset()
    got = cuda_mlp.mlp(x, w1, b1, w2, b2, save_residuals=True)
    assert cuda_mlp.counters.mlp_fwd == 1
    want = cuda_mlp.mlp_reference(x, w1, b1, w2, b2, save_residuals=True)
    for name, a, b in zip(("o", "a", "s"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    assert torch.equal(cuda_mlp.mlp(x, w1, b1, w2, b2), got[0])
    _o, a, s = got
    g = _randn(cuda_device, m, c, seed=8)
    grads = cuda_mlp.mlp_bwd_cuda(x, a, s, g, w1, w2)
    assert cuda_mlp.counters.mlp_bwd == 1
    for name, p, q in zip(PLAIN_MLP_GRADS, grads,
                          cuda_mlp.mlp_backward_reference(x, a, s, g, w1, w2)):
        _assert_grad(name, p, q)
    # the same from run to run: no atomics anywhere
    assert all(torch.equal(p, q) for p, q in zip(
        cuda_mlp.mlp_bwd_cuda(x, a, s, g, w1, w2), grads))
    assert (cuda_mlp.counters.fwd, cuda_mlp.counters.bwd) == (0, 0)


def _heads_case(device, layout, b_, nh, hd, window, nw):
    """(q, k, v, dense bias, mask, scale) with q, k, v (B_, N, nh, hd) as
    views of a packed tensor, as tensors of their own, or as views of
    head-major (nh, B_, N, hd) tensors."""
    qkv, vc, mask, wd = _attn_case(device, b_, nh, hd, window, nw)
    n = qkv.shape[1]
    q, k, v = qkv.reshape(b_, n, 3, nh, hd).unbind(2)
    if layout == "own":
        q, k, v = (t.contiguous() for t in (q, k, v))
    elif layout == "head_major":
        q, k, v = (t.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
                   for t in (q, k, v))
    return q, k, v, cuda_bias.expand_bias_reference(vc, wd), mask, hd ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "own", "head_major"])
@pytest.mark.parametrize("case", [
    dict(b_=8, nh=3, hd=32, window=(8, 7, 7), nw=4),
    dict(b_=2, nh=24, hd=32, window=(8, 7, 7), nw=0),
    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3),
    dict(b_=4, nh=1, hd=24, window=(3, 5, 5), nw=2)], ids=str)
def test_heads_attention_kernels_match_plain(cuda_device, case, layout):
    ca = cuda_attention
    q, k, v, bias, mask, scale = _heads_case(cuda_device, layout, **case)
    if case["nh"] > 1:      # with one head every layout is the same memory
        assert q.is_contiguous() == (layout == "own")
    ca.counters.reset()
    got = ca.window_attention_heads(q, k, v, bias, mask, scale)
    assert ca.counters.heads_fwd == 1
    want = ca.attention_reference(q, k, v, bias, mask, scale)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    out, ms = ca.attn_heads_fwd_cuda(q, k, v, bias, mask, scale, save_ms=True)
    assert ca.counters.heads_fwd == 2 and torch.equal(out, got)
    g = _randn(cuda_device, *q.shape, seed=9)
    grads = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)
    assert ca.counters.heads_bwd == 1
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads,
                          ca.heads_attention_backward_reference(
                              q, k, v, bias, mask, g, scale)):
        assert a.is_contiguous()
        _assert_grad(name, a, b)
    assert all(torch.equal(a, b) for a, b in zip(
        ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale), grads))
    # the packed kernels' counters do not move
    assert (ca.counters.fwd, ca.counters.bwd) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mlp", "heads"])
def test_unfused_ops_differentiate_through_their_kernels(cuda_device,
                                                         float32_matmul, op):
    """``backward`` through the wrapper launches the backward kernel once,
    copies nothing, and gives the gradients of autograd through the plain
    forward; under ``no_grad`` nothing is kept."""
    from vitta_tpu_torch.models import swin
    dev = cuda_device
    if op == "mlp":
        x, _g, _bt, w1, b1, w2, b2 = _mlp_case(dev, 24, 16)
        ins, mod, names = [x, w1, b1, w2, b2], cuda_mlp, ("mlp_fwd", "mlp_bwd")
        fn, plain = cuda_mlp.mlp, cuda_mlp.mlp_reference
    else:
        qkv, vc, mask, wd = _attn_case(dev, 6, 3, 8, (2, 3, 3), 3)
        ins = [qkv, cuda_bias.expand_bias_reference(vc, wd)]
        mod, names = cuda_attention, ("heads_fwd", "heads_bwd")

        def on_views(f):
            return lambda a, b: f(*a.reshape(6, 18, 3, 3, 8).unbind(2), b,
                                  mask, 8 ** -0.5)
        fn = on_views(cuda_attention.window_attention_heads)
        plain = on_views(cuda_attention.attention_reference)
    got_in = [t.clone().requires_grad_() for t in ins]
    want_in = [t.clone().requires_grad_() for t in ins]
    mod.counters.reset()
    swin.counters.reset()
    out = fn(*got_in)
    cot = _randn(dev, *out.shape, seed=20)
    got = torch.autograd.grad(out, got_in, cot)
    assert tuple(getattr(mod.counters, n) for n in names) == (1, 1)
    assert swin.counters.contiguity_copies == 0
    want = torch.autograd.grad(plain(*want_in), want_in, cot)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_grad(f"{op} input {i}", a, b)
    with torch.no_grad():
        assert fn(*got_in).grad_fn is None


@pytest.mark.cuda
def test_unfused_kernels_reject_what_they_do_not_take(cuda_device):
    dev = cuda_device
    x, _g, _bt, w1, b1, w2, b2 = _mlp_case(dev, 24, 16)
    with pytest.raises(TypeError):
        cuda_mlp.mlp(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(ValueError):       # weights in the (in, out) layout
        cuda_mlp.mlp(x, w1.t().contiguous(), b1, w2, b2)
    with pytest.raises(ValueError):       # C = 6 is no multiple of 4
        cuda_mlp.mlp(_randn(dev, 4, 6), _randn(dev, 24, 6), _randn(dev, 24),
                     _randn(dev, 6, 24), _randn(dev, 6))
    q, k, v, bias, mask, scale = _heads_case(dev, "views", 6, 3, 8, (2, 3, 3),
                                             3)
    ca = cuda_attention
    with pytest.raises(TypeError):
        ca.window_attention_heads(q.bfloat16(), k, v, bias, mask, scale)
    with pytest.raises(ValueError):       # a head's channels strided
        ca.window_attention_heads(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v, bias, mask,
            scale)
    with pytest.raises(ValueError):       # the compact bias form
        ca.window_attention_heads(q, k, v, _randn(dev, 3, 3, 9, 9), mask,
                                  scale)
    with pytest.raises(ValueError):       # hd = 64 > 32
        ca.window_attention_heads(*(_randn(dev, 2, 18, 1, 64),) * 3,
                                  _randn(dev, 1, 18, 18), None, 0.125)
    far = torch.zeros(6_000_000 + 4, device=dev).as_strided(
        (1, 2, 1, 4), (0, 6_000_000, 4, 1))
    with pytest.raises(ValueError):       # tokens too far apart
        ca.window_attention_heads(far, far, far, _randn(dev, 1, 2, 2), None,
                                  0.5)
    with pytest.raises(ValueError):       # a strided cotangent, unwrapped
        ca.attn_heads_bwd_cuda(q, k, v, bias, mask, _randn(dev, 6, 18, 6),
                               _randn(dev, 6, 3, 18, 8).transpose(1, 2), scale)


# ---------------------------------------------------------------------------
# BatchNorm (inference) + ReLU + channel statistics (csrc/bn_stats.cu)

def _bn_inputs(device, lead, c, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(*lead, c)) * 2.0 + offset,    # x
            rng.random(c) + 0.5, rng.normal(size=c),       # scale, bias
            rng.normal(size=c), rng.random(c) + 0.5,       # mean, var
            rng.normal(size=(*lead, c)),                   # cotangent of y
            rng.normal(size=c), rng.normal(size=c))        # of m and of v
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]


def _bn_value_and_grads(fn, relu, x, scale, bias, mean, var, g_y, g_m, g_v):
    x, scale, bias = (t.clone().requires_grad_() for t in (x, scale, bias))
    y, (m, v) = fn(x, scale, bias, mean, var, relu=relu)
    torch.autograd.backward((y, m, v), (g_y, g_m, g_v))
    return [y.detach(), m.detach(), v.detach(), x.grad, scale.grad, bias.grad]


def _assert_bn_close(got, want):
    for g, w, name in zip(got[:3], want[:3], ("y", "mean", "var")):
        rtol, atol = (1e-4, 1e-5) if name == "var" else (1e-5, 1e-5)
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=name)
    for g, w, name in zip(got[3:], want[3:], ("dx", "dscale", "dbias")):
        _assert_grad(name, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("lead,c", [
    ((1024,), 128), ((200,), 256), ((100,), 32), ((37,), 30), ((1,), 5),
    ((4, 7, 7), 2048), ((32, 28, 28), 256), ((2, 16), 64), ((512,), 33)],
    ids=str)
def test_bn_stats_kernels_match_plain(cuda_device, lead, c, relu):
    ins = _bn_inputs(cuda_device, lead, c)
    cuda_stats.counters.reset()
    got = _bn_value_and_grads(cuda_stats.fused_bn_relu_stats, relu, *ins)
    assert (cuda_stats.counters.fwd, cuda_stats.counters.bwd) == (1, 1)
    want = _bn_value_and_grads(cuda_stats.fused_bn_relu_stats_reference,
                               relu, *ins)
    assert got[0].shape == ins[0].shape and got[1].shape == (c,)
    _assert_bn_close(got, want)
    again = _bn_value_and_grads(cuda_stats.fused_bn_relu_stats, relu, *ins)
    for a, b in zip(got, again):
        assert torch.equal(a, b)      # no atomics: two runs are bit-equal


@pytest.mark.cuda
def test_bn_stats_backward_kernel_matches_its_plain_version(cuda_device):
    x, scale, bias, mean, var, g_y, g_m, g_v = _bn_inputs(
        cuda_device, (300,), 96, seed=1)
    for relu in (False, True):
        _y, m, _v = cuda_stats.bn_stats_fwd_cuda(x, scale, bias, mean, var,
                                                 1e-5, relu)
        for cots in ((g_y, g_m, g_v), (g_y, None, None), (None, g_m, None),
                     (None, None, g_v)):
            got = cuda_stats.bn_stats_bwd_cuda(x, scale, bias, mean, var, m,
                                               *cots, 1e-5, relu)
            want = cuda_stats.fused_bn_relu_stats_backward_reference(
                x, scale, bias, mean, var, m, *cots, eps=1e-5, relu=relu)
            for g, w, name in zip(got, want, ("dx", "dscale", "dbias")):
                if name == "dbias" and not relu and cots[0] is None \
                        and cots[1] is None:
                    # sum_rows(y - m) is 0 but for rounding: nothing to
                    # scale the error by
                    assert float(g.abs().max()) <= 1e-5
                    continue
                _assert_grad(f"{name} relu={relu}", g, w)


@pytest.mark.cuda
def test_bn_stats_with_a_cotangent_on_the_statistics_only(cuda_device):
    """The adaptation loss reads m and v of a layer whose y also feeds the
    next layer; a layer read for its statistics alone has no cotangent on
    y, and none is made."""
    ins = _bn_inputs(cuda_device, (64, 7), 48, seed=2)

    def grads(fn):
        x, scale, bias = (t.clone().requires_grad_() for t in ins[:3])
        _y, (m, v) = fn(x, scale, bias, ins[3], ins[4], relu=False)
        ((m * ins[6]).sum() + (v * ins[7]).sum()).backward()
        return x.grad, scale.grad, bias.grad

    for g, w, name in zip(grads(cuda_stats.fused_bn_relu_stats),
                          grads(cuda_stats.fused_bn_relu_stats_reference),
                          ("dx", "dscale", "dbias")):
        _assert_grad(name, g, w)


@pytest.mark.cuda
def test_bn_stats_variance_of_an_offset_channel(cuda_device):
    """``E[y^2] - m^2`` cancels where |m| is far above the spread: the
    kernel stays within the plain version's own tolerance there."""
    ins = _bn_inputs(cuda_device, (25088,), 256, seed=3, offset=30.0)
    _y, (m, v) = cuda_stats.fused_bn_relu_stats(*ins[:5], relu=False)
    _yr, (mr, vr) = cuda_stats.fused_bn_relu_stats_reference(*ins[:5],
                                                             relu=False)
    torch.testing.assert_close(m, mr, rtol=1e-5, atol=1e-5)
    # the two one-pass forms each carry a few roundings of m^2
    bound = 8 * torch.finfo(torch.float32).eps * float((mr * mr).max())
    assert float((v - vr).abs().max()) <= bound + 1e-4 * float(vr.abs().max())


@pytest.mark.cuda
def test_bn_stats_saves_no_residual_under_no_grad(cuda_device):
    x, scale, bias, mean, var = _bn_inputs(cuda_device, (50,), 16)[:5]
    scale.requires_grad_()
    with torch.no_grad():
        y, _stats = cuda_stats.fused_bn_relu_stats(x, scale, bias, mean, var)
    assert y.grad_fn is None and not y.requires_grad
    y, _m, _v = cuda_stats.BnReluStats.apply(x, scale, bias, mean, var, 1e-5,
                                             True, True)
    assert len(y.grad_fn.saved_tensors) == 6   # x, the four vectors, m


@pytest.mark.cuda
def test_bn_stats_kernels_reject_what_they_do_not_take(cuda_device):
    x, scale, bias, mean, var, g_y = _bn_inputs(cuda_device, (40,), 16)[:6]
    with pytest.raises(TypeError, match="float32"):
        cuda_stats.fused_bn_relu_stats(x.double(), scale, bias, mean, var)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stats.fused_bn_relu_stats(x.T.contiguous().T, scale, bias, mean,
                                       var)
    with pytest.raises(ValueError, match="shape"):
        cuda_stats.fused_bn_relu_stats(x, scale[:-1], bias, mean, var)
    with pytest.raises(ValueError, match="no gradient"):
        cuda_stats.fused_bn_relu_stats(x, scale, bias,
                                       mean.clone().requires_grad_(), var)
    xg = x.clone().requires_grad_()
    y, _stats = cuda_stats.fused_bn_relu_stats(xg, scale, bias, mean, var)
    strided = torch.empty(16, 40, device=cuda_device).T    # (40, 16) strided
    with pytest.raises(ValueError, match="contiguous"):
        y.backward(strided)


@pytest.mark.cuda
def test_tapped_batch_norm_goes_through_the_kernel(cuda_device):
    """``BatchNorm`` in the inference form with the "stat" leaf read takes
    y and the leaf from the kernel, and only at the layers ``Taps`` names;
    values and gradients as the plain path's."""
    from vitta_tpu_torch.models.layers import BatchNorm, Taps
    torch.manual_seed(0)
    x = torch.randn(4, 6, 6, 24, device=cuda_device)

    def run(names, read_stat=True):
        bn = BatchNorm(24, "a.bn").to(cuda_device)
        torch.manual_seed(1)           # the same layer in every run
        with torch.no_grad():
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.uniform_(0.5, 1.5)
        taps = Taps({"stat"}, names)
        xr = x.clone().requires_grad_()
        y = bn(xr, taps)
        loss = y.square().sum()
        if read_stat:
            s = taps["a.bn"]["stat"]
            loss = loss + s.mean.sum() + 3 * s.var.sum()
        loss.backward()
        return y.detach(), xr.grad, bn.weight.grad, bn.bias.grad, taps

    cuda_stats.counters.reset()
    kernel = run({"a.bn"})
    assert (cuda_stats.counters.fwd, cuda_stats.counters.bwd) == (1, 1)
    plain = run({"other"}, read_stat=False)
    assert (cuda_stats.counters.fwd, cuda_stats.counters.bwd) == (1, 1)
    assert not plain[4]
    # the same y; the gradients differ by the statistics' term, which the
    # tests above hold against the plain op under autograd
    torch.testing.assert_close(kernel[0], plain[0], rtol=1e-5, atol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in kernel[1:4])
