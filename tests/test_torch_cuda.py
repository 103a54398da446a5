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
backward kernels are not ported: ``backward`` on a CUDA tensor raises.
"""

import numpy as np
import pytest
import torch

from vitta_tpu_torch.ops import (cuda_attention, cuda_bias, cuda_ln,
                                 cuda_mlp, cuda_tam)
from vitta_tpu_torch.ops.cuda_tam import (tam_dynamic_conv,
                                          tam_dynamic_conv_reference)

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


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ln", "bias", "attention", "ln_mlp"])
def test_swin_ops_raise_in_backward_on_the_card(cuda_device, op):
    dev = cuda_device
    if op == "ln":
        x = _randn(dev, 8, 128).requires_grad_()
        out = cuda_ln.layer_norm(x, _randn(dev, 128), _randn(dev, 128))
    elif op == "bias":
        v = _randn(dev, 2, 3, 9, 9).requires_grad_()
        out = cuda_bias.expand_bias(v, 2)
    elif op == "attention":
        qkv, vc, mask, _wd = _attn_case(dev, 6, 3, 8, (2, 3, 3), 3)
        out = cuda_attention.window_attention_packed(
            qkv.requires_grad_(), vc, mask, 8 ** -0.5, 3)
    else:
        x = _randn(dev, 8, 8).requires_grad_()
        out, _y = cuda_mlp.ln_mlp(x, _randn(dev, 8), _randn(dev, 8),
                                  _randn(dev, 32, 8), _randn(dev, 32),
                                  _randn(dev, 8, 32), _randn(dev, 8))
    with pytest.raises(NotImplementedError, match="PERF.md"):
        out.sum().backward()


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
