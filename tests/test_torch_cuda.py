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
(``PROJ_GRAD_REL``: four tiled products and the attention's in the chain,
where the LayerNorm-MLP backward has two).  The MLP without the LayerNorm
and the attention per (head, window) are held to the bounds of the
LayerNorm-MLP and of the packed attention.  The BatchNorm-statistics
kernels: y and the mean rtol / atol 1e-5, the variance rtol 1e-4 / atol 1e-5
(tests/test_pallas_stats.py's: ``E[y^2] - m^2`` from sums taken in another
order), every gradient to 2e-5 of its tensor's largest magnitude.  The
bfloat16 kernels: see the two bfloat16 sections at the end.
"""

import numpy as np
import pytest
import torch

from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                 cuda_bias, cuda_ln, cuda_mlp, cuda_stats,
                                 cuda_tam)
from vitta_tpu_torch.ops.cuda_tam import (tam_dynamic_conv,
                                          tam_dynamic_conv_reference)
from vitta_tpu_torch.ops._launch import launches_of

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-5, 2e-4
SHAPES = [dict(), dict(t=3), dict(h=16), dict(n=1, t=16, h=7, w=7, c=64),
          dict(n=2, t=16, h=14, w=14, c=256), dict(c=30, w=5),
          # the backward's edge cases: one frame; one frame past its chunk
          # depth at 16-byte columns; channels no multiple of 4 at T = 16
          dict(t=1), dict(t=cuda_tam.BWD_DEPTH + 1, h=7, w=7, c=64),
          dict(n=2, t=16, h=7, w=5, c=30)]


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
@pytest.mark.parametrize("shape", SHAPES[4:], ids=str)
def test_backward_gives_the_same_bits_twice(cuda_device, shape):
    """No float atomics: two runs of the backward give the same bits."""
    x, attn, kernel, cot = _inputs(cuda_device, **shape)
    first = cuda_tam.tam_bwd_cuda(cot, x, attn, kernel)
    again = cuda_tam.tam_bwd_cuda(cot, x, attn, kernel)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_backward_launches(cuda_device):
    """Two launches a call: the blocks' kernel and the sum of their partial
    rows (the library's own counts)."""
    x, attn, kernel, cot = _inputs(cuda_device, **SHAPES[4])
    names = launches_of(lambda: cuda_tam.tam_bwd_cuda(cot, x, attn, kernel))
    assert sum(names.values()) == 2, names
    assert sum(n for k, n in names.items() if "tam_bwd_kernel" in k) == 1
    assert sum(n for k, n in names.items() if "tam_bwd_reduce" in k) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,p,c", [(2, 16, 3136, 64), (2, 16, 3136, 128),
                                     (2, 16, 784, 128), (2, 16, 784, 256),
                                     (2, 16, 196, 256), (2, 16, 196, 512),
                                     (2, 16, 49, 512), (1, 16, 49, 512),
                                     (2, 3, 196, 256), (2, 1, 35, 30),
                                     (2, 9, 35, 64), (1, 17, 12, 20),
                                     (3, 40, 7, 8)])
def test_backward_plan_matches_the_kernels(cuda_device, n, t, p, c):
    """``bwd_plan``, which the CPU tests follow, is the kernel's own, with
    16-byte units and, where C % 4 == 0, with one channel a thread."""
    for vec in ((1, 0) if c % 4 == 0 else (0,)):
        assert (cuda_tam.bwd_plan_cuda(n, t, p, c, vec)
                == cuda_tam.bwd_plan(n, t, p, c, vec)), vec


@pytest.mark.cuda
def test_backward_takes_unaligned_views(cuda_device):
    """Contiguous views that start 4 bytes past a 16-byte boundary take the
    one-channel path (no misaligned 16-byte access) and give the plain
    version's gradients."""
    x, attn, kernel, cot = _inputs(cuda_device, **SHAPES[4])

    def shifted(v):
        buf = torch.empty(v.numel() + 1, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out

    xs, attns, cots = shifted(x), shifted(attn), shifted(cot)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 4
    assert cuda_tam.bwd_vec(x.shape[-1], cots, xs, attns) == 0
    got = cuda_tam.tam_bwd_cuda(cots, xs, attns, kernel)
    torch.cuda.synchronize()
    want = _value_and_grads(tam_dynamic_conv_reference, x, attn, kernel,
                            cot)[1:]
    for g, w, name in zip(got, want, ("dx", "dattn", "dkernel")):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=name)


@pytest.mark.cuda
def test_kernel_rejects_bfloat16_and_strided_input(cuda_device):
    """The kernels take float32 and bfloat16 x (bfloat16 since the bfloat16
    TANet): float16 and float64 raise, as do a bfloat16 attn, a cotangent of
    another dtype than x's and a strided x."""
    x, attn, kernel, cot = _inputs(cuda_device)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            tam_dynamic_conv(x.to(dtype), attn, kernel)
    with pytest.raises(TypeError):
        cuda_tam.tam_fwd_cuda(x.bfloat16(), attn.bfloat16(), kernel)
    with pytest.raises(TypeError):
        cuda_tam.tam_bwd_cuda(cot, x.bfloat16(), attn, kernel)
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
                                       ((3, 2, 5), 32), ((2, 3, 3), 32),
                                       ((4, 7, 7), 32), ((16, 14, 14), 2),
                                       ((2, 70, 70), 1)])
def test_bias_kernel_matches_plain_exactly(cuda_device, window, nh):
    """Both store paths (16-byte where N % 4 == 0, else scalar), shared
    memory beyond 48 KB ((16, 14, 14)) and rows that do not fit in it,
    read from V where they lie ((2, 70, 70))."""
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


# the backward's shapes: small ones, then Swin-T's widths 96, 384 and 1536
# and Swin-B's 2048 at the rows of the adapt batch, and the widest single
# floats (sixteen warps a row)
LN_BWD_SHAPES = [(392, 128), (1000, 256), (777, 512), (33, 1024), (9, 2048),
                 (50, 96), (7, 8), (50176, 96), (3136, 384), (784, 1536),
                 (784, 2048), (10, 4090)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", LN_BWD_SHAPES)
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
@pytest.mark.parametrize("rows,c", LN_BWD_SHAPES + [(50176, 128),
                                                    (3136, 512), (1, 8)])
def test_ln_backward_plan_matches_the_kernels(cuda_device, rows, c):
    """``ln_bwd_plan``, which the CPU tests follow, is the kernel's own, in
    float4 units and in single floats."""
    for vec in ((1, 0) if c % 4 == 0 else (0,)):
        assert (cuda_ln.ln_bwd_plan_cuda(rows, c, vec)
                == cuda_ln.ln_bwd_plan(rows, c, vec)), vec


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(3136, 512), (784, 2048), (50, 96),
                                    (7, 8)])
def test_ln_backward_gives_the_same_bits_twice(cuda_device, rows, c):
    """Two launches a call (dx with the blocks' partials, their sum in
    block order), no float atomics: the same bits every run."""
    x = _randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5
    g, dy = _randn(cuda_device, c, seed=2), _randn(cuda_device, rows, c, seed=3)
    first = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    names = launches_of(lambda: cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5))
    assert sum(names.values()) == 2, names
    assert names.get("reduce_partials_kernel") == 1, names
    again = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_ln_backward_takes_unaligned_views(cuda_device):
    """Contiguous views that start 4 bytes past a 16-byte boundary take the
    single-float path (no misaligned 16-byte access) and give the plain
    version's gradients; the C entry refuses float4 units on them."""
    rows, c = 300, 128

    def shifted(v):
        buf = torch.empty(v.numel() + 1, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out

    x = shifted(_randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5)
    dy = shifted(_randn(cuda_device, rows, c, seed=3))
    g = _randn(cuda_device, c, seed=2)
    assert cuda_ln.bwd_vec(c, x, g, dy) == 0
    names = launches_of(lambda: cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5))
    assert any(k.startswith("ln_bwd_kernel<false") for k in names), names
    got = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        _assert_grad(name, a, b)
    lib = cuda_ln._lib()
    dx = torch.empty(rows, c, device=cuda_device)
    dgb = torch.empty(2, c, device=cuda_device)
    scratch = torch.empty(lib.vitta_ln_bwd_scratch_floats(rows, c),
                          device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.vitta_ln_bwd(x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                            dx.data_ptr(), dgb.data_ptr(), scratch.data_ptr(),
                            rows, c, 1e-5, 1, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("window,nh", [((8, 7, 7), 4), ((2, 3, 3), 2),
                                       ((3, 2, 5), 32), ((4, 7, 7), 32),
                                       ((16, 14, 14), 2), ((2, 70, 70), 1),
                                       ((16, 16, 16), 1)])
def test_bias_collapse_kernel_matches_plain_exactly(cuda_device, window, nh):
    """16-byte copies where N % 4 == 0, else single floats; shared memory
    beyond 48 KB ((16, 14, 14): 200 KB, (2, 70, 70): 78 KB), and rows that
    do not fit in it, read where they lie ((16, 16, 16): 256 KB); one
    launch a call."""
    wd, wh, ww = window
    n = wd * wh * ww
    db = _randn(cuda_device, nh, n, n, seed=4)
    cuda_bias.counters.reset()
    got = cuda_bias.collapse_bias_cuda(db, wd)
    assert cuda_bias.counters.bwd == 1
    assert torch.equal(got, cuda_bias.collapse_bias_reference(db, wd))
    names = launches_of(lambda: cuda_bias.collapse_bias_cuda(db, wd))
    staged = wd * n * 4 <= 227 * 1024
    assert names == {("collapse_bias_staged<true>" if staged and n % 4 == 0
                      else "collapse_bias_staged<false>" if staged
                      else "collapse_bias_direct"): 1}, names


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
        names = launches_of(fn)
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
    for dtype in (torch.float16, torch.float64):   # float32, bfloat16 only
        with pytest.raises(TypeError):
            cuda_ln.layer_norm(x.to(dtype), g, g)
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
    for name, a, b in zip(("out", "qkv", "o_att", "ms"), got, want):
        torch.testing.assert_close(a, b, rtol=PROJ_TOL, atol=PROJ_TOL,
                                   msg=name)
    torch.testing.assert_close(
        cp.attn_proj_fwd(x, *w, bias, mask, scale, nh), got[0], rtol=0, atol=0)
    _out, qkv, o_att, ms = got
    g = _randn(cuda_device, *x.shape, seed=17)
    # the backward from the kept qkv, the kernel's and the plain version's
    args = (x, qkv, w[0], w[2], bias, mask, o_att, ms, g, scale, nh)
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
    for name, a, b in zip(("out", "y", "qkv", "o_att", "ms"), got, want):
        torch.testing.assert_close(a, b, rtol=PROJ_TOL, atol=PROJ_TOL,
                                   msg=name)
    _out, y, qkv, o_att, ms = got
    g = _randn(cuda_device, *x.shape, seed=17)
    gy = _randn(cuda_device, *x.shape, seed=18) if with_gy else None
    args = (x, y, qkv, gm, 1e-5, w[0], w[2], bias, mask, o_att, ms, g, gy,
            scale, nh)
    grads = cp.attn_ln_proj_bwd(*args)
    assert cp.counters.ln_proj_bwd == 1
    for name, a, b in zip(LN_PROJ_GRADS, grads,
                          cp.ln_proj_attention_backward_reference(*args)):
        _assert_grad(name, a, b, PROJ_GRAD_REL)
    assert all(torch.equal(a, b)
               for a, b in zip(cp.attn_ln_proj_bwd(*args), grads))


def proj_bwd_launches(fn, with_ln):
    """{kernel name: launches} of one backward call ``fn``, checked against
    the chain's budget: a pair of products in one launch or two, before and
    after the attention backward (2 or 3 launches), the LayerNorm
    backward's one (dx and its blocks' partials), and one reduce for every
    partial sum; no
    qkv product, no LayerNorm forward, no separate column sums (the
    libraries' own counts)."""
    names = launches_of(fn)
    total = sum(names.values())
    grouped = sum(n for k, n in names.items() if "gemm_pair" in k)
    products = grouped + sum(n for k, n in names.items() if "gemm_tiles" in k)
    assert products == 4 - grouped, names
    assert total <= (11 if with_ln else 8) - grouped, names
    assert sum(n for k, n in names.items() if "reduce_sums" in k) == 1, names
    assert sum(n for k, n in names.items() if "attn_bwd_kernel" in k) == 1
    for absent in ("col_sums", "reduce_partials", "ln_rows_vec",
                   "ln_rows_any", "attn_fwd_kernel", "false, false, 0>"):
        assert not any(absent in k for k in names), (absent, names)
    return names


# the backward's cases and how many of its two pairs of products run as one
# launch (csrc/gemm_tiles.cuh:pair_grouped): both at PROJ_CASES[0] and at
# PROJ_CASES[2] (a tile of 64), the g_att pair alone at Swin-B's stage 2
CHAIN_CASES = [(PROJ_CASES[0], 2), (PROJ_CASES[2], 2),
               (dict(b_=32, nh=8, hd=32, window=(8, 7, 7), nw=16), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["proj", "ln_proj"])
@pytest.mark.parametrize("case,pairs", CHAIN_CASES, ids=str)
def test_proj_backward_chain(cuda_device, float32_matmul, case, pairs, op):
    """The backward from the kept qkv (and y) against the plain version,
    within its launch budget, the same bits twice."""
    cp = cuda_attention_proj
    x, gm, bt, w, bias, mask, scale = _proj_case(cuda_device, **case)
    nh = case["nh"]
    g = _randn(cuda_device, *x.shape, seed=17)
    if op == "proj":
        _out, qkv, o_att, ms = cp.attn_proj_fwd(x, *w, bias, mask, scale, nh,
                                                True)
        args = (x, qkv, w[0], w[2], bias, mask, o_att, ms, g, scale, nh)
        run, plain, names = (cp.attn_proj_bwd,
                             cp.proj_attention_backward_reference,
                             PROJ_GRADS)
    else:
        _out, y, qkv, o_att, ms = cp.attn_ln_proj_fwd(
            x, gm, bt, 1e-5, *w, bias, mask, scale, nh, True)
        gy = _randn(cuda_device, *x.shape, seed=18)
        args = (x, y, qkv, gm, 1e-5, w[0], w[2], bias, mask, o_att, ms, g,
                gy, scale, nh)
        run, plain, names = (cp.attn_ln_proj_bwd,
                             cp.ln_proj_attention_backward_reference,
                             LN_PROJ_GRADS)
    got = run(*args)
    for name, a, b in zip(names, got, plain(*args)):
        _assert_grad(name, a, b, PROJ_GRAD_REL)
    assert all(torch.equal(a, b) for a, b in zip(run(*args), got))
    launches = proj_bwd_launches(lambda: run(*args), op == "ln_proj")
    assert sum(n for k, n in launches.items() if "gemm_pair" in k) == pairs


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
    # qkv (three activations), o_att and ms are kept (y too, an output):
    # four activations and the rows' statistics, less than five
    x = ins[0]
    assert 4 * x.numel() * 4 <= extra_grad < 5 * x.numel() * 4


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
    for dtype in (torch.float16, torch.float64):   # float32, bfloat16 only
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cuda_stats.fused_bn_relu_stats(x.to(dtype), scale, bias, mean,
                                           var)
    with pytest.raises(TypeError, match="float32"):   # parameters: float32
        cuda_stats.fused_bn_relu_stats(x.bfloat16(), scale.bfloat16(), bias,
                                       mean, var)
    with pytest.raises(TypeError):     # a cotangent of another dtype than x
        cuda_stats.bn_stats_bwd_cuda(x.bfloat16(), scale, bias, mean, var,
                                     mean, g_y, None, None)
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


# --------------------------------------------------------------------------
# bfloat16: the TAM and BatchNorm-statistics kernels (rows 1, 2 and 7) in
# the bfloat16 TANet, against their plain versions at the same rounding
# points.  bf16 x bf16 products are exact in float32 and the plain versions
# add in the kernels' order, so the TAM's out and dx are the twin's bits;
# dattn and dkernel are float32 sums in another order (GRAD_TOL).  y and dx
# of the BatchNorm come from float32 formulas that may round a few values
# apart (rsqrt and the fused multiply-add): one bfloat16 ulp, or, near 0,
# a few float32 roundings of the terms that cancel there; its
# statistics and parameter gradients are float32 sums (the float32
# tolerances above).
BF16 = torch.bfloat16
# ResNet-50's TAM sites (H, W, C) at the adapt batch (n=2), the eval clip
# (n=1) and t=3, and the one-channel path (C % 4 != 0)
BF16_TAM_SHAPES = [dict(n=n, t=t, h=h, w=h, c=c)
                   for h, c in ((56, 64), (56, 128), (28, 128), (28, 256),
                                (14, 256), (14, 512), (7, 512))
                   for n, t in ((2, 16), (1, 16), (2, 3))]
BF16_TAM_SHAPES += [dict(n=2, t=5, h=7, w=5, c=30), dict(t=1, c=24)]


def _bf16_tam_inputs(device, **shape):
    x, attn, kernel, cot = _inputs(device, **shape)
    return x.to(BF16), attn, kernel, cot.to(BF16)


def _within_one_bf16_ulp(name, got, want):
    """|got - want| <= one bfloat16 ulp of |want|, or 2^-20 of the largest
    |want| where a value near 0 is the difference of larger float32 terms
    (a few float32 roundings of those)
    (vitta_tpu_torch/tools/bf16_checks.py); returns how many values
    differ."""
    from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
    share, _ulps, _err = assert_bf16_within(name, got, want)
    return round(share * want.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_TAM_SHAPES, ids=str)
def test_tam_bf16_kernels_match_plain(cuda_device, shape):
    x, attn, kernel, cot = _bf16_tam_inputs(cuda_device, **shape)
    out = launches_of(lambda: cuda_tam.tam_fwd_cuda(x, attn, kernel))
    assert sum(out.values()) == 1 and all(
        "bf16" in k or "bfloat16" in k for k in out), out
    # 16-byte units (C % 8 == 0): one launch, the cross-block sums inside
    # it; one channel a thread: the blocks' kernel and the sum of its rows
    names = launches_of(lambda: cuda_tam.tam_bwd_cuda(cot, x, attn, kernel))
    if shape["c"] % 8 == 0:
        assert names == {"tam_bwd_bf16x8_kernel": 1}, names
    else:
        assert sum(names.values()) == 2, names
        assert names.get("tam_bwd_kernel<float, __nv_bfloat16>") == 1, names
    cuda_tam.counters.reset()
    got = _value_and_grads(tam_dynamic_conv, x, attn, kernel, cot)
    assert (cuda_tam.counters.fwd, cuda_tam.counters.bwd) == (1, 1)
    assert got[0].dtype == got[1].dtype == BF16
    assert got[2].dtype == got[3].dtype == torch.float32
    want_out = tam_dynamic_conv_reference(x, attn, kernel)
    want = cuda_tam.tam_dynamic_conv_backward_reference(cot, x, attn, kernel)
    assert torch.equal(got[0], want_out)
    assert torch.equal(got[1], want[0])
    for g, w, name in zip(got[2:], want[1:], ("dattn", "dkernel")):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=name)
    again = cuda_tam.tam_bwd_cuda(cot, x, attn, kernel)
    assert all(torch.equal(a, b) for a, b in zip(again, got[1:]))


@pytest.mark.cuda
def test_tam_bf16_takes_unaligned_views(cuda_device):
    """bfloat16 views 2 bytes past a 16-byte boundary take the one-channel
    forward and backward, with the plain versions' values."""
    x, attn, kernel, cot = _bf16_tam_inputs(cuda_device,
                                            **BF16_TAM_SHAPES[12])

    def shifted(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out

    xs, cots = shifted(x), shifted(cot)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 2
    c = x.shape[-1]
    assert cuda_tam.fwd_vec_bf16(c, xs, attn, xs) == 0
    assert cuda_tam.bwd_vec(c, cots, xs, attn, xs) == 0
    assert cuda_tam.bwd_vec(c, cot, x, attn, x) == 1
    fwd = launches_of(lambda: cuda_tam.tam_fwd_cuda(xs, attn, kernel))
    assert list(fwd) == ["tam_fwd_kernel<__nv_bfloat16>"], fwd
    bwd = launches_of(lambda: cuda_tam.tam_bwd_cuda(cots, xs, attn, kernel))
    assert "tam_bwd_kernel<float, __nv_bfloat16>" in bwd, bwd
    assert torch.equal(cuda_tam.tam_fwd_cuda(xs, attn, kernel),
                       tam_dynamic_conv_reference(x, attn, kernel))
    got = cuda_tam.tam_bwd_cuda(cots, xs, attn, kernel)
    want = cuda_tam.tam_dynamic_conv_backward_reference(cot, x, attn, kernel)
    assert torch.equal(got[0], want[0])
    for g, w, name in zip(got[1:], want[1:], ("dattn", "dkernel")):
        torch.testing.assert_close(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=name)


def _bf16_bn_inputs(device, lead, c, seed=0):
    ins = _bn_inputs(device, lead, c, seed)
    ins[0], ins[5] = ins[0].to(BF16), ins[5].to(BF16)
    return ins


def _assert_bn_within_one_bf16_ulp(got, want):
    _within_one_bf16_ulp("y", got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5,
                               msg="mean")
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5,
                               msg="var")
    _within_one_bf16_ulp("dx", got[3], want[3])
    for g, w, name in zip(got[4:], want[4:], ("dscale", "dbias")):
        _assert_grad(name, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("lead,c", [
    ((25088,), 256), ((6272,), 256), ((6272,), 1024), ((6272,), 512),
    ((1568,), 512), ((1568,), 2048),          # a TANet mean_var step's
    ((200,), 24), ((37,), 30), ((1,), 5), ((2, 16), 64)], ids=str)
def test_bn_stats_bf16_kernels_match_plain(cuda_device, lead, c, relu):
    ins = _bf16_bn_inputs(cuda_device, lead, c)
    cuda_stats.counters.reset()
    got = _bn_value_and_grads(cuda_stats.fused_bn_relu_stats, relu, *ins)
    assert (cuda_stats.counters.fwd, cuda_stats.counters.bwd) == (1, 1)
    assert got[0].dtype == got[3].dtype == BF16
    assert all(t.dtype == torch.float32 for t in got[1:3] + got[4:])
    x2 = ins[0].reshape(-1, c)
    m = got[1]
    want_y, (want_m, want_v) = cuda_stats.fused_bn_relu_stats_reference(
        *ins[:5], relu=relu)
    want_b = cuda_stats.fused_bn_relu_stats_backward_reference(
        x2, *ins[1:5], m, ins[5].reshape(-1, c), ins[6], ins[7], relu=relu)
    _assert_bn_within_one_bf16_ulp(got, [want_y, want_m, want_v,
                                want_b[0].reshape(ins[0].shape),
                                *want_b[1:]])
    again = _bn_value_and_grads(cuda_stats.fused_bn_relu_stats, relu, *ins)
    for a, b in zip(got, again):
        assert torch.equal(a, b)      # no atomics: two runs are bit-equal
    wide = c % 8 == 0
    names = launches_of(lambda: cuda_stats.bn_stats_fwd_cuda(
        x2, *ins[1:5], 1e-5, relu))
    want_name = (f"bn_stats_fwd_kernel<{8 if wide else 1}, "
                 f"{str(relu).lower()}, __nv_bfloat16>")
    assert names == {want_name: 1}, names     # one launch a call
    names = launches_of(lambda: cuda_stats.bn_stats_bwd_cuda(
        x2, *ins[1:5], m, ins[5].reshape(-1, c), ins[6], ins[7], 1e-5, relu))
    assert names == {want_name.replace("fwd", "bwd"): 1}, names


@pytest.mark.cuda
def test_bn_stats_bf16_takes_unaligned_views(cuda_device):
    """A bfloat16 x 2 bytes past a 16-byte boundary takes the one-value
    path, forward and backward, with the plain versions' values."""
    x, scale, bias, mean, var, g_y, g_m, g_v = _bf16_bn_inputs(
        cuda_device, (300,), 96, seed=1)
    buf = torch.empty(x.numel() + 1, dtype=BF16, device=cuda_device)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 == 2
    names = launches_of(lambda: cuda_stats.bn_stats_fwd_cuda(
        xs, scale, bias, mean, var, 1e-5, False))
    assert names == {"bn_stats_fwd_kernel<1, false, __nv_bfloat16>": 1}, names
    y, m, v = cuda_stats.bn_stats_fwd_cuda(xs, scale, bias, mean, var, 1e-5,
                                           False)
    want_y, (want_m, want_v) = cuda_stats.fused_bn_relu_stats_reference(
        x, scale, bias, mean, var, relu=False)
    _within_one_bf16_ulp("y", y, want_y)
    torch.testing.assert_close(m, want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, want_v, rtol=1e-4, atol=1e-5)
    names = launches_of(lambda: cuda_stats.bn_stats_bwd_cuda(
        xs, scale, bias, mean, var, m, g_y, g_m, g_v, 1e-5, False))
    assert names == {"bn_stats_bwd_kernel<1, false, __nv_bfloat16>": 1}, names
    got = cuda_stats.bn_stats_bwd_cuda(xs, scale, bias, mean, var, m, g_y,
                                       g_m, g_v, 1e-5, False)
    want = cuda_stats.fused_bn_relu_stats_backward_reference(
        x, scale, bias, mean, var, m, g_y, g_m, g_v, relu=False)
    _within_one_bf16_ulp("dx", got[0], want[0])
    for g, w, name in zip(got[1:], want[1:], ("dscale", "dbias")):
        _assert_grad(name, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("rows,c", [(25088, 2048), (1, 5)], ids=str)
def test_bn_stats_repeats_and_graph_replays_are_bit_equal(cuda_device, rows,
                                                          c, dtype):
    """Three calls in a row, then a CUDA graph of the forward and backward
    replayed twice, then an eager call again: the same bits each time, so
    every launch left the tickets it drew at 0 (many chunks and column
    tiles; a single block)."""
    x, scale, bias, mean, var, g_y, g_m, g_v = _bn_inputs(
        cuda_device, (rows,), c, seed=5)
    x, g_y = x.to(dtype), g_y.to(dtype)

    def run():
        y, m, v = cuda_stats.bn_stats_fwd_cuda(x, scale, bias, mean, var,
                                               1e-5, False)
        return [y, m, v, *cuda_stats.bn_stats_bwd_cuda(
            x, scale, bias, mean, var, m, g_y, g_m, g_v, 1e-5, False)]

    def assert_equal(got, want):
        torch.cuda.synchronize()
        for name, a, b in zip(("y", "m", "v", "dx", "dscale", "dbias"), got,
                              want):
            assert torch.equal(a, b), name

    first = run()
    for _ in range(2):
        assert_equal(run(), first)
    side = torch.cuda.Stream(cuda_device)    # warm-up before a capture
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        assert_equal(run(), first)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        assert_equal(captured, first)
    assert_equal(run(), first)


@pytest.mark.cuda
def test_bn_stats_plan_is_the_mirror(cuda_device):
    """The kernels' own plan (csrc/bn_stats.cu) against
    ``cuda_stats.bn_plan`` at the clusters the card holds, at the sites of
    a TANet step, the TAM's BatchNorm1d and odd sizes, for each instance."""
    shapes = [(25088, 256), (6272, 256), (6272, 1024), (6272, 512),
              (1568, 512), (1568, 2048), (512, 32), (32, 64), (1, 5),
              (37, 30), (200, 33), (25088, 2048)]
    for rows, c in shapes:
        for dtype, wide in ((torch.float32, 4), (BF16, 8)):
            for v in (1, wide):
                for bwd in (False, True):
                    own = cuda_stats.bn_plan_cuda(rows, c, v, dtype, bwd)
                    resident, sms = own.pop("resident"), own.pop("sms")
                    assert resident >= 1 and sms >= 1
                    assert own == cuda_stats.bn_plan(rows, c, v, resident,
                                                     sms), \
                        (rows, c, v, dtype, bwd)


@pytest.mark.cuda
def test_bf16_tanet_runs_through_the_kernels(cuda_device):
    """The bfloat16 TANet's tapped forward and backward on the card: every
    TAM and every tapped BatchNorm2d through the bfloat16 kernels (the
    libraries' counts), the TAM branches' BatchNorm1d (float32 there, as in
    vitta_tpu) through the float32 ones."""
    from vitta_tpu_torch.models.layers import Taps
    from vitta_tpu_torch.models.tanet import TANet
    torch.manual_seed(0)
    model = TANet(5, clip_length=4, dtype="bfloat16").to(cuda_device)
    x = torch.randn(2, 4, 64, 64, 3, device=cuda_device)

    def step():
        taps = Taps({"stat"})
        logits = model(x, taps)
        loss = logits.sum() + sum(v["stat"].var.sum() for v in taps.values())
        loss.backward()
    names = launches_of(step)

    def count(*parts, bf16=True):
        return sum(n for k, n in names.items()
                   if all(p in k for p in parts)
                   and ("bfloat16" in k or "bf16" in k) == bf16)
    assert count("tam_fwd") == 16 and count("tam_fwd", bf16=False) == 0
    # the TAM backward in one launch a call (tam_bwd_bf16x8_kernel), none of
    # the two-launch form (tam_bwd_kernel and its reduce)
    assert count("tam_bwd_bf16x8_kernel") == 16, names
    assert count("tam_bwd_kernel") == 0, names
    assert count("tam_bwd", bf16=False) == 0, names
    for d in ("fwd", "bwd"):
        assert count(f"bn_stats_{d}_kernel") == 53, names
        assert count(f"bn_stats_{d}_kernel", bf16=False) == 32, names


# --------------------------------------------------------------------------
# bfloat16: the Video Swin-B kernels (rows 3, 4, 10, 11, 14 and 15) in the
# bfloat16 Swin, against their plain versions, which round where the
# kernels round (vitta_tpu's rounding points at the compute dtype), by
# vitta_tpu_torch/tools/bf16_checks.py: every bfloat16 output within one
# bfloat16 ulp of the plain version's (or 2^-20 of its tensor's largest
# magnitude, for a value near 0 that is the difference of larger float32
# terms); the LayerNorm-MLP's outputs each from the kernel's own rounded
# inputs to that step (a, and dh, its rounded form and dy from the
# backward's scratch); the attention's each from the kernel's own rounded e
# and dl (its instances that write bfloat16(e), and dl in the backward's
# scratch), with e within one ulp and dl within GRAD_REL of their plain
# values, and end to end at most 1e-4 of the values beyond one ulp (or 2^-12
# of the largest), those within 2^-7 of the absolute products through e and
# dl.  Float32 outputs (dgamma, dbeta, dh, dy, dbias, ms) to GRAD_REL / 2e-5,
# as at float32.
# Inputs are rounded to bfloat16 once; the plain versions run on the card.
# Swin-B and Swin-T at one clip: every LayerNorm shape (tokens, C), the
# stage widths and the merging norms, and rows and widths off the Swin
# sites (C = 8 and 24: units past the row; 1040: 32 lanes of 5 units)
SWIN_B_LN_BF16 = [(25088, 128), (6272, 256), (1568, 512), (392, 1024),
                  (6272, 512), (1568, 1024), (392, 2048), (25088, 96),
                  (6272, 192), (6272, 384), (1568, 384), (1568, 768),
                  (392, 768), (392, 1536), (50, 96), (7, 8), (33, 24),
                  (5, 1040)]
SWIN_B_MLP_BF16 = [(25088, 128), (6272, 256), (1568, 512), (392, 1024),
                   (3136, 512), (784, 1024), (77, 256), (9, 8)]
SWIN_B_ATTN_BF16 = [dict(b_=64, nh=4, hd=32, window=(8, 7, 7), nw=64),
                    dict(b_=128, nh=4, hd=32, window=(8, 7, 7), nw=64),
                    dict(b_=16, nh=8, hd=32, window=(8, 7, 7), nw=16),
                    dict(b_=4, nh=16, hd=32, window=(8, 7, 7), nw=4),
                    dict(b_=2, nh=32, hd=32, window=(8, 7, 7), nw=0),
                    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3),
                    dict(b_=4, nh=2, hd=16, window=(3, 2, 5), nw=0),
                    dict(b_=4, nh=2, hd=16, window=(3, 5, 5), nw=2)]


def _bf16_randn(device, *shape, seed=0, scale=1.0):
    return _randn(device, *shape, seed=seed, scale=scale).to(BF16)


def _bf16_names(names):
    """The launches of bfloat16 kernel instances among ``names``."""
    return {k: n for k, n in names.items() if "bf16" in k or "bfloat16" in k}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", SWIN_B_LN_BF16, ids=str)
def test_ln_bf16_kernels_match_plain(cuda_device, rows, c):
    x = (_randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5).to(BF16)
    g, b = _randn(cuda_device, c, seed=2), _randn(cuda_device, c, seed=3)
    dy = _bf16_randn(cuda_device, rows, c, seed=4)
    cuda_ln.counters.reset()
    xg = x.clone().requires_grad_()
    gg, bg = g.clone().requires_grad_(), b.clone().requires_grad_()
    y = cuda_ln.layer_norm(xg, gg, bg, 1e-5)
    y.backward(dy)
    assert (cuda_ln.counters.fwd, cuda_ln.counters.bwd) == (1, 1)
    assert y.dtype == xg.grad.dtype == BF16
    assert gg.grad.dtype == bg.grad.dtype == torch.float32
    _within_one_bf16_ulp("y", y.detach(), cuda_ln.layer_norm_reference(x, g, b, 1e-5))
    want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
    _within_one_bf16_ulp("dx", xg.grad, want[0])
    _assert_grad("dgamma", gg.grad, want[1])
    _assert_grad("dbeta", bg.grad, want[2])
    fwd = launches_of(lambda: cuda_ln.ln_fwd_cuda(x, g, b, 1e-5))
    assert sum(fwd.values()) == 1 and _bf16_names(fwd) == fwd, fwd
    # every aligned C % 8 == 0 up to 2048 takes the 16-byte form, the
    # instance its plan names
    plan = cuda_ln.ln_fwd_bf16_plan_cuda(rows, c)
    assert cuda_ln.fwd_vec_bf16(c, x, g, b) == 1
    assert fwd == {f"ln_fwd_bf16x8<{plan['units']}, {plan['lanes']}>": 1}, \
        fwd
    assert torch.equal(cuda_ln.ln_fwd_cuda(x, g, b, 1e-5), y.detach())
    # 16-byte units (every C here % 8 == 0): one launch a call, the blocks'
    # column sums finished inside it
    bwd = launches_of(lambda: cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5))
    assert sum(bwd.values()) == 1, bwd
    assert all(k.startswith("ln_bwd_bf16x8<") for k in bwd), bwd
    again = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    assert torch.equal(again[0], xg.grad)     # no atomics: bit-equal
    assert torch.equal(again[1], gg.grad)


@pytest.mark.cuda
def test_ln_bf16_takes_unaligned_views(cuda_device):
    """bfloat16 views 2 bytes past a 16-byte boundary take the one-value
    forward and backward, with the plain versions' values."""
    rows, c = 300, 256
    x = (_randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5).to(BF16)
    dy = _bf16_randn(cuda_device, rows, c, seed=3)
    g, b = _randn(cuda_device, c, seed=2), _randn(cuda_device, c, seed=4)

    def shifted(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out

    xs, dys = shifted(x), shifted(dy)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 2
    assert cuda_ln.bwd_vec(c, xs, g, dys) == 0
    assert cuda_ln.bwd_vec(c, x, g, dy) == 1
    assert cuda_ln.bwd_vec_bf16(c, xs, g, dys) == 0
    assert cuda_ln.bwd_vec_bf16(c, x, g, dy) == 2
    assert cuda_ln.fwd_vec_bf16(c, xs, g, b) == 0
    assert cuda_ln.fwd_vec_bf16(c, x, g, b) == 1
    fwd = launches_of(lambda: cuda_ln.ln_fwd_cuda(xs, g, b, 1e-5))
    assert fwd == {"ln_rows_any<__nv_bfloat16>": 1}, fwd
    _within_one_bf16_ulp("y", cuda_ln.ln_fwd_cuda(xs, g, b, 1e-5),
                cuda_ln.layer_norm_reference(x, g, b, 1e-5))
    bwd = launches_of(lambda: cuda_ln.ln_bwd_cuda(xs, g, dys, 1e-5))
    assert any(k.startswith("ln_bwd_kernel<false") and "bfloat16" in k
               for k in bwd), bwd
    got = cuda_ln.ln_bwd_cuda(xs, g, dys, 1e-5)
    want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
    _within_one_bf16_ulp("dx", got[0], want[0])
    _assert_grad("dgamma", got[1], want[1])
    _assert_grad("dbeta", got[2], want[2])


def _bf16_mlp_case(device, m, c):
    x, g, bt, w1, b1, w2, b2 = _mlp_case(device, m, c)
    return (x.to(BF16), g, bt, w1.to(BF16), b1.to(BF16), w2.to(BF16),
            b2.to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", SWIN_B_MLP_BF16, ids=str)
def test_ln_mlp_bf16_kernels_match_plain(cuda_device, m, c):
    from vitta_tpu_torch.tools.bf16_checks import (ln_mlp_bwd_stages,
                                                   ln_mlp_fwd_stages)
    x, g, bt, w1, b1, w2, b2 = _bf16_mlp_case(cuda_device, m, c)
    cuda_mlp.counters.reset()
    got = cuda_mlp.ln_mlp_fwd_cuda(x, g, bt, w1, b1, w2, b2, 1e-5,
                                   save_residuals=True)
    assert cuda_mlp.counters.fwd == 1
    _o, y, a, s = got
    want = ln_mlp_fwd_stages(x, g, bt, w1, b1, w2, b2, 1e-5, y, a)
    for name, p, q in zip(("o", "y", "a", "s"), got, want):
        _within_one_bf16_ulp(name, p, q)
    # the backward from what the forward kept, with and without gy, each
    # step against the plain version on the kernel's own inputs to it
    go = _bf16_randn(cuda_device, m, c, seed=8)
    f = 4 * c
    scratch = torch.empty(cuda_mlp.ln_mlp_bwd_scratch_floats(m, c, f, BF16),
                          dtype=torch.float32, device=cuda_device)
    for gy in (_bf16_randn(cuda_device, m, c, seed=9, scale=0.1), None):
        res = cuda_mlp.ln_mlp_bwd_cuda(x, y, a, s, go, gy, g, w1, w2, 1e-5,
                                       scratch=scratch)
        dh, dhc, dy = cuda_mlp.bf16_bwd_scratch_views(scratch, m, c, f)
        ref = ln_mlp_bwd_stages(x, y, a, s, go, gy, g, w1, w2, 1e-5, dh,
                                dhc, dy)
        _assert_grad("dh", dh, ref["dh"])
        assert torch.equal(dhc, ref["dhc"])       # dh rounded once
        _assert_grad("dy", dy, ref["dy"])
        for name, r in zip(MLP_GRADS, res):
            if name in ("dgamma", "dbeta"):
                assert r.dtype == torch.float32, name
                _assert_grad(name, r, ref[name])
            else:
                _within_one_bf16_ulp(name, r, ref[name])
        again = cuda_mlp.ln_mlp_bwd_cuda(x, y, a, s, go, gy, g, w1, w2, 1e-5)
        assert all(torch.equal(p, q) for p, q in zip(res, again))
    fwd = launches_of(lambda: cuda_mlp.ln_mlp_fwd_cuda(
        x, g, bt, w1, b1, w2, b2, 1e-5, save_residuals=True))
    assert sum(fwd.values()) == 3 and _bf16_names(fwd) == fwd, fwd
    bwd = launches_of(lambda: cuda_mlp.ln_mlp_bwd_cuda(
        x, y, a, s, go, None, g, w1, w2, 1e-5))
    # the backward's products in 3 launches (dh, dy, and dw1 with dw2 in
    # one), and at most 10 launches a call (12 on mma.sync): db1 is summed in
    # the dh product's epilogue (its column partials per 64 rows, then
    # reduce_partials), no col_sums_kernel pass over dh; a weight gradient
    # whose plan leaves K in one chunk is rounded in the epilogue, with no
    # reduce_partials launch
    assert sum(n for k, n in fwd.items() if "gemm_wgmma_bf16" in k) == 2, fwd
    assert sum(n for k, n in bwd.items() if "gemm_wgmma_bf16" in k) == 3, bwd
    assert not any(k.startswith("gemm_tiles") for k in {**fwd, **bwd}), bwd
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert sum(bwd.values()) == cuda_mlp.bf16_bwd_launches(m, c, f, sms), bwd
    assert sum(n for k, n in bwd.items() if k.startswith("col_sums")) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", SWIN_B_MLP_BF16, ids=str)
def test_bf16_gemm_plan_matches_the_kernels(cuda_device, m, c):
    """``bf16_gemm_plan``, which the CPU tests of the summation order
    follow, is the library's own on this card."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (cuda_mlp.bf16_gemm_plan_cuda(m, c, 4 * c)
            == cuda_mlp.bf16_gemm_plan(m, c, 4 * c, sms))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(77, 64), (3136, 512), (784, 1024)],
                         ids=str)
def test_bf16_products_match_float32(cuda_device, m, c):
    """Each of the six wgmma products alone, on bfloat16 operands, against
    the float32 product of the same values: float32 outputs (dh, dy) to
    1e-5 of their largest value, bfloat16 ones within one ulp."""
    f = 4 * c
    bf = lambda *shape, seed, scale=1.0: _bf16_randn(cuda_device, *shape,
                                                      seed=seed, scale=scale)
    y, w1, b1 = bf(m, c, seed=1), bf(f, c, seed=2, scale=c ** -0.5), \
        bf(f, seed=3, scale=0.1)
    a, w2, b2 = bf(m, f, seed=4), bf(c, f, seed=5, scale=f ** -0.5), \
        bf(c, seed=6, scale=0.1)
    go, s, gy, dhc = bf(m, c, seed=7), bf(m, f, seed=8), \
        bf(m, c, seed=9, scale=0.1), bf(m, f, seed=10)
    f32 = lambda t: t.float()
    h = f32(y) @ f32(w1).t() + f32(b1)
    ga, gs = cuda_mlp.bf16_product_cuda("h", y, w1, b1)
    _within_one_bf16_ulp("a", ga, torch.nn.functional.gelu(h).to(BF16))
    _within_one_bf16_ulp("s", gs, cuda_mlp.gelu_derivative(h).to(BF16))
    _within_one_bf16_ulp("o", cuda_mlp.bf16_product_cuda("o", a, w2, b2),
                         (f32(a) @ f32(w2).t() + f32(b2)).to(BF16))
    dh, dhc_k = cuda_mlp.bf16_product_cuda("dh", go, w2, aux=s)
    want = (f32(go) @ f32(w2)) * f32(s)
    _assert_grad("dh", dh, want)
    assert torch.equal(dhc_k, dh.to(BF16))
    for aux in (gy, None):
        want = f32(dhc) @ f32(w1) + (0 if aux is None else f32(aux))
        _assert_grad("dy", cuda_mlp.bf16_product_cuda("dy", dhc, w1,
                                                      aux=aux), want)
    _within_one_bf16_ulp("dw1", cuda_mlp.bf16_product_cuda("dw1", dhc, y),
                         (f32(dhc).t() @ f32(y)).to(BF16))
    _within_one_bf16_ulp("dw2", cuda_mlp.bf16_product_cuda("dw2", go, a),
                         (f32(go).t() @ f32(a)).to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", SWIN_B_ATTN_BF16, ids=str)
def test_attention_bf16_kernels_match_plain(cuda_device, case, compact):
    from vitta_tpu_torch.tools.bf16_checks import (
        assert_bf16_mostly_within, packed_attention_bf16_bwd_stages,
        packed_attention_bf16_fwd_stage, packed_attention_bf16_intermediates,
        packed_attention_bf16_slack)
    qkv, vc, mask, wd = _attn_case(cuda_device, **case)
    qkv = qkv.to(BF16)
    nh, hd = case["nh"], case["hd"]
    scale = hd ** -0.5
    bias = vc if compact else cuda_bias.expand_bias_reference(vc, wd)
    cuda_attention.counters.reset()
    out, ms = cuda_attention.attn_packed_fwd_cuda(qkv, bias, mask, scale, nh,
                                                  save_ms=True)
    assert cuda_attention.counters.fwd == 1
    want, want_ms = cuda_attention.packed_attention_bf16_reference(
        qkv, bias, mask, scale, nh, save_ms=True)
    torch.testing.assert_close(ms, want_ms, rtol=2e-5, atol=2e-5)
    g = _bf16_randn(cuda_device, *out.shape, seed=5)
    # each step on the kernel's own rounded e and dl, and those against
    # their plain values
    tf, tb = {}, {}
    out_t, ms_t = cuda_attention.attn_packed_fwd_cuda(
        qkv, bias, mask, scale, nh, save_ms=True, taps=tf)
    assert torch.equal(out_t, out) and torch.equal(ms_t, ms)
    e_want, dl_want = packed_attention_bf16_intermediates(
        qkv, bias, mask, ms, g, scale, nh)
    _within_one_bf16_ulp("forward e", tf["e"], e_want)
    _within_one_bf16_ulp("out from the kernel's e", out,
                         packed_attention_bf16_fwd_stage(qkv, ms, tf["e"], nh))
    dqkv, dbias = cuda_attention.attn_packed_bwd_cuda(qkv, bias, mask, ms, g,
                                                      scale, nh)
    dqkv_t, dbias_t = cuda_attention.attn_packed_bwd_cuda(
        qkv, bias, mask, ms, g, scale, nh, taps=tb)
    assert torch.equal(dqkv_t, dqkv) and torch.equal(dbias_t, dbias)
    _within_one_bf16_ulp("backward e", tb["e"], e_want)
    _assert_grad("dl", tb["dl"], dl_want)
    _within_one_bf16_ulp("dqkv from the kernel's e and dl", dqkv,
                         packed_attention_bf16_bwd_stages(
                             qkv, ms, g, tb["e"], tb["dl"], scale, nh))
    # end to end against the plain version on its own e and dl
    wq, wb = cuda_attention.packed_attention_bf16_backward_reference(
        qkv, bias, mask, ms, g, scale, nh)
    slack_out, slack_dqkv = packed_attention_bf16_slack(qkv, bias, mask, ms,
                                                        g, scale, nh)
    assert_bf16_mostly_within("out", out, want, slack_out)
    assert_bf16_mostly_within("dqkv", dqkv, wq, slack_dqkv)
    assert dbias.dtype == torch.float32
    _assert_grad("dbias", dbias, wb)
    again = cuda_attention.attn_packed_bwd_cuda(qkv, bias, mask, ms, g, scale,
                                                nh)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)
    fwd = launches_of(lambda: cuda_attention.attn_packed_fwd_cuda(
        qkv, bias, mask, scale, nh))
    assert fwd == {"attn_fwd_bf16_kernel" if compact
                   else "attn_fwd_dense_bf16_kernel": 1}, fwd
    if not compact:
        # the dense backward forms q k^T by the forward's products
        assert torch.equal(tf["e"], tb["e"])
    bwd = launches_of(lambda: cuda_attention.attn_packed_bwd_cuda(
        qkv, bias, mask, ms, g, scale, nh))
    split = cuda_attention.bwd_split(case["b_"], nh, cuda_device)
    assert bwd.get("attn_bwd_bf16_kernel") == 1, bwd
    assert bwd.get("dkv_sum_kernel<__nv_bfloat16>", 0) == (split > 1), bwd
    # dbias: the windows' compact partials added, or dl summed (dense)
    n = qkv.shape[1]
    assert bwd.get("dbias_windows_kernel" if compact
                   else cuda_attention.dense_dbias_reduce_kernel(n, nh)) \
        == 1, bwd
    assert sum(bwd.values()) == 2 + (split > 1), bwd


@pytest.mark.cuda
def test_bf16_swin_backward_keeps_dl_on_chip(cuda_device, monkeypatch):
    """On the model's path the bfloat16 attention backward takes the compact
    bias, and its scratch holds the (window, head) partials of the compact
    dbias and the blocks' shares of dk and dv: no (B_, nh, N, N) dl."""
    from vitta_tpu_torch.models.layers import Taps
    seen = []
    real = cuda_attention._bwd_scratch

    def spy(b_, n, nh, hd, dev, dtype=torch.float32, compact=False, wd=0,
            hw=0, tap=False):
        out = real(b_, n, nh, hd, dev, dtype, compact, wd, hw, tap)
        seen.append((b_, n, nh, hd, dtype, compact, wd, hw, tap,
                     out.numel()))
        return out
    monkeypatch.setattr(cuda_attention, "_bwd_scratch", spy)
    model = _bf16_swin(cuda_device)
    x = torch.randn(2, 4, 48, 48, 3, device=cuda_device)
    taps = Taps({"stat"})
    logits = model(x, taps, train=True)
    (logits.sum() + sum(v["stat"].var.sum() for v in taps.values())).backward()
    assert len(seen) == 3, seen
    for b_, n, nh, hd, dtype, compact, wd, hw, tap, floats in seen:
        assert dtype == BF16 and compact and not tap, seen
        split = cuda_attention.bwd_split(b_, nh, cuda_device)
        partials = b_ * nh * (2 * wd - 1) * hw * hw
        shares = 2 * split * b_ * nh * n * hd if split > 1 else 0
        assert floats == partials + shares, seen
        assert floats - shares < b_ * nh * n * n, seen


@pytest.mark.cuda
def test_bf16_swin_kernels_refuse_unaligned_views(cuda_device):
    """The bfloat16 LayerNorm-MLP and attention kernels move 16-byte units
    of 8 values and refuse a tensor 2 bytes past a 16-byte boundary (the
    LayerNorm takes it: test_ln_bf16_takes_unaligned_views)."""
    x, g, bt, w1, b1, w2, b2 = _bf16_mlp_case(cuda_device, 24, 16)
    buf = torch.empty(x.numel() + 1, dtype=BF16, device=cuda_device)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_mlp.ln_mlp(xs, g, bt, w1, b1, w2, b2)
    qkv, vc, mask, wd = _attn_case(cuda_device, 6, 3, 8, (2, 3, 3), 3)
    qkv = qkv.to(BF16)
    buf = torch.empty(qkv.numel() + 1, dtype=BF16, device=cuda_device)
    qs = buf[1:].view(qkv.shape)
    qs.copy_(qkv)
    bias = cuda_bias.expand_bias_reference(vc, wd)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_attention.window_attention_packed(qs, bias, mask, 8 ** -0.5, 3)
    with pytest.raises(TypeError):            # the bias stays float32
        cuda_attention.window_attention_packed(qkv, bias.to(BF16), mask,
                                               8 ** -0.5, 3)
    with pytest.raises(TypeError):            # gamma and beta stay float32
        cuda_mlp.ln_mlp(x, g.to(BF16), bt, w1, b1, w2, b2)
    with pytest.raises(TypeError):            # so do the MLP's weights not
        cuda_mlp.ln_mlp(x, g, bt, w1.float(), b1, w2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ln", "attention", "ln_mlp"])
def test_bf16_swin_ops_differentiate_through_their_kernels(cuda_device, op):
    """Under autograd each bfloat16 op runs its forward and its backward
    kernel once, returns bfloat16 gradients for bfloat16 inputs and
    float32 ones for float32 inputs."""
    fn, _plain, ins, mod = _op_case(cuda_device, op)
    ins = [t.to(BF16) if i == 0 or (op == "ln_mlp" and i >= 3) else t
           for i, t in enumerate(ins)]
    ins = [t.requires_grad_() for t in ins]
    mod.counters.reset()
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(o.float().sum() for o in outs).backward()
    assert (mod.counters.fwd, mod.counters.bwd) == (1, 1)
    for t in ins:
        assert t.grad is not None and t.grad.dtype == t.dtype


def _bf16_swin(device, embed_dim=128, route="packed"):
    from vitta_tpu_torch.models.swin import Recognizer3D
    torch.manual_seed(0)
    return Recognizer3D(5, window_size=(2, 3, 3), embed_dim=embed_dim,
                        depths=(2, 1), num_heads=(4, 8), attn_route=route,
                        dtype="bfloat16").to(device)


@pytest.mark.cuda
def test_bf16_swin_runs_through_the_kernels(cuda_device):
    """The bfloat16 Swin's tapped forward and backward on the card: every
    LayerNorm, LayerNorm-MLP and packed attention through the bfloat16
    kernels (the libraries' counts), none through a float32 one."""
    from vitta_tpu_torch.models.layers import Taps
    model = _bf16_swin(cuda_device)
    x = torch.randn(2, 4, 48, 48, 3, device=cuda_device)

    def step():
        taps = Taps({"stat"})
        logits = model(x, taps, train=True)
        loss = logits.sum() + sum(v["stat"].var.sum() for v in taps.values())
        loss.backward()
    names = launches_of(step)

    def count(part, bf16=True):
        return sum(n for k, n in names.items()
                   if part in k and ("bfloat16" in k or "bf16" in k) == bf16)
    # 6 LayerNorms of their own (norm1 of the 3 blocks, the patch-embed,
    # merging and final norms) and norm2 in each of the 3 LayerNorm-MLPs, all
    # in 16-byte units (no one-value ln_rows_any); the 6 standalone
    # backwards in one ln_bwd_bf16x8 launch each, the LN-MLPs' LayerNorm step
    # on ln_bwd_kernel
    assert count("ln_fwd_bf16x8") == 6 + 3, names
    assert count("ln_rows") == count("ln_rows", bf16=False) == 0, names
    assert count("ln_bwd_bf16x8") == 6, names
    assert count("ln_bwd_kernel") == 3, names
    assert count("attn_fwd_bf16_kernel") == 3, names
    assert count("attn_bwd_bf16_kernel") == 3, names
    # 2 products a forward, 3 launches a backward (dw1 and dw2 in one)
    assert count("gemm_wgmma_bf16") == 3 * (2 + 3), names
    for part in ("attn_fwd_kernel", "attn_bwd_kernel", "gemm_tiles<"):
        assert count(part, bf16=False) == 0, names
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


@pytest.mark.cuda
def test_bf16_swin_half_twin_gives_the_bits_of_casting_at_use(cuda_device):
    """On the card, two adapt+eval steps of the small bfloat16 Swin with
    the engine's bfloat16 twin of the cast weights (foreach copies) and
    casting them at every use: the same losses, predictions, EMA and
    float32 masters, bit for bit."""
    import dataclasses
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import compute_source_statistics
    from vitta_tpu_torch.tools.synthetic import (normalized_batches,
                                                 swin_cfg, swin_model,
                                                 swin_weights, videos)
    cfg = swin_cfg(t=4, hw=48, embed_dim=128, depths=(2, 1),
                   num_heads=(4, 8), window_size=(2, 3, 3))
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=1e-3),
                      tta=dataclasses.replace(
                          cfg.tta, chosen_blocks=("layers.1",
                                                  "backbone.norm")))
    sd = swin_weights(cfg, 0)
    rng = np.random.default_rng(0)
    source = swin_model(cfg)
    source.load_state_dict(sd)
    src = compute_source_statistics(
        source, normalized_batches(rng, cfg, (2,), 4, 48), device=cuda_device)
    clips = videos(rng, 2, 4, 48)
    runs = []
    for twin in (True, False):
        eng = VittaEngine(swin_model(cfg, "bfloat16", drop_path_rate=0.0,
                                     head_dropout=0.0), cfg, sd, src,
                          device=cuda_device, half_twin=twin)
        assert (eng._twin is not None) == twin
        state, metrics = eng.init_state(), []
        for views, clip, label in clips:
            state, m = eng.adapt_eval_step(state, views, clip, label)
            metrics.append([getattr(m, f) for f in
                            ("loss_reg", "loss_consis", "loss_ce", "pred")])
        runs.append((metrics, eng.model.state_dict(), state.ema))
    (m1, p1, e1), (m2, p2, e2) = runs
    for a, b in zip(m1, m2):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(x, y) for k in e1 for x, y in zip(e1[k], e2[k]))


# Video Swin-T at bfloat16: the MLP without the LayerNorm (rows 8-9) at
# stages 1-2 for 2 and 1 clips, a ragged M, a narrow C; the attention per
# (head, window) (rows 12-13) at every Swin-T stage for 2 clips and small
# windows
SWIN_T_MLP_BF16 = [(50176, 96), (12544, 192), (25088, 96), (6272, 192),
                   (77, 96), (9, 48)]
SWIN_T_ATTN_BF16 = [dict(b_=128, nh=3, hd=32, window=(8, 7, 7), nw=64),
                    dict(b_=32, nh=6, hd=32, window=(8, 7, 7), nw=16),
                    dict(b_=8, nh=12, hd=32, window=(8, 7, 7), nw=4),
                    dict(b_=2, nh=24, hd=32, window=(8, 7, 7), nw=0),
                    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", SWIN_T_MLP_BF16, ids=str)
def test_mlp_bf16_kernels_match_plain(cuda_device, m, c):
    """The bfloat16 MLP without the LayerNorm (csrc/mlp_fused_bf16.cuh):
    each step within one ulp of its plain version on the kernel's own
    rounded a, dh and dhc, dhc dh rounded once, two backward runs bit-equal,
    the forward without residuals the residual one's bits and allocating no
    (M, F) tensor; one launch a forward (mlp_rows_bf16<C, false>), three a
    backward (the row pass, dw1 and dw2 in one gemm_wgmma_bf16 launch, one
    reduce_sums_kernel), the count the library's and
    ``bf16_bwd_launches``'s, the plan ``mlp_rows_plan``'s."""
    from vitta_tpu_torch.tools.bf16_checks import (mlp_bwd_stages,
                                                   mlp_fwd_stages)
    x, _g, _bt, w1, b1, w2, b2 = _bf16_mlp_case(cuda_device, m, c)
    f = 4 * c
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (cuda_mlp.mlp_rows_plan_cuda(m, c, f)
            == cuda_mlp.mlp_rows_plan(m, c, f, sms))
    cuda_mlp.counters.reset()
    got = cuda_mlp.mlp_fwd_cuda(x, w1, b1, w2, b2, save_residuals=True)
    assert cuda_mlp.counters.mlp_fwd == 1
    _o, a, s = got
    for name, p, q in zip(("o", "a", "s"), got,
                          mlp_fwd_stages(x, w1, b1, w2, b2, a)):
        _within_one_bf16_ulp(name, p, q)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    o_eval = cuda_mlp.mlp_fwd_cuda(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(o_eval, got[0])
    assert (torch.cuda.max_memory_allocated(cuda_device) - before
            < max(m * f * 2, 512))
    g = _bf16_randn(cuda_device, m, c, seed=8)
    taps = {}
    res = cuda_mlp.mlp_bwd_cuda(x, a, s, g, w1, w2, taps=taps)
    ref = mlp_bwd_stages(x, a, s, g, w1, w2, taps["dh"], taps["dhc"])
    _assert_grad("dh", taps["dh"], ref["dh"])
    assert torch.equal(taps["dhc"], ref["dhc"])       # dh rounded once
    for name, r in zip(PLAIN_MLP_GRADS, res):
        _within_one_bf16_ulp(name, r, ref[name])
    again = cuda_mlp.mlp_bwd_cuda(x, a, s, g, w1, w2)
    assert all(torch.equal(p, q) for p, q in zip(res, again))
    fwd = launches_of(lambda: cuda_mlp.mlp_fwd_cuda(x, w1, b1, w2, b2, True))
    assert fwd == {f"mlp_rows_bf16<{c}, false>": 1}, fwd
    bwd = launches_of(lambda: cuda_mlp.mlp_bwd_cuda(x, a, s, g, w1, w2))
    assert bwd.pop(f"mlp_rows_bf16<{c}, true>") == 1, bwd
    assert bwd.pop("reduce_sums_kernel") == 1, bwd
    assert bwd == _bf16_names(bwd) and sum(bwd.values()) == 1, bwd
    assert all(k.startswith("gemm_wgmma_bf16") for k in bwd), bwd
    assert (cuda_mlp.mlp_bf16_bwd_launches_cuda(m, c, f) == 3
            == cuda_mlp.bf16_bwd_launches(m, c, f, sms, ln=False))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", SWIN_T_MLP_BF16, ids=str)
def test_mlp_bf16_plan_matches_the_kernels(cuda_device, m, c):
    """At Swin-T's extents (K and N of 96 and 192) the library's cut of the
    six products is ``bf16_gemm_plan``'s, which
    tests/test_torch_gemm_bf16_order.py follows on the CPU."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (cuda_mlp.bf16_gemm_plan_cuda(m, c, 4 * c)
            == cuda_mlp.bf16_gemm_plan(m, c, 4 * c, sms))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "own"])
@pytest.mark.parametrize("case", SWIN_T_ATTN_BF16, ids=str)
def test_heads_attention_bf16_kernels_match_plain(cuda_device, case, layout):
    """The bfloat16 attention per (head, window), on q, k, v as views of a
    packed output and as tensors of their own: each step within one ulp of
    its plain version on the kernel's own rounded e and dl, e and dl
    against their plain values, out, dq, dk, dv end to end as the card's
    check holds them, dbias to GRAD_REL, two backward runs bit-equal, the
    packed pair's bfloat16 launches."""
    from vitta_tpu_torch.tools import bf16_checks as bc
    q, k, v, bias, mask, scale = _heads_case(cuda_device, layout, **case)
    q, k, v = (t.to(BF16) for t in (q, k, v)) if layout == "own" else \
        torch.stack([q, k, v], dim=2).to(BF16).unbind(2)
    ca = cuda_attention
    ca.counters.reset()
    out, ms = ca.attn_heads_fwd_cuda(q, k, v, bias, mask, scale, save_ms=True)
    assert ca.counters.heads_fwd == 1 and out.dtype == BF16
    want, want_ms = ca.heads_attention_bf16_reference(q, k, v, bias, mask,
                                                      scale, save_ms=True)
    torch.testing.assert_close(ms, want_ms, rtol=2e-5, atol=2e-5)
    g = _bf16_randn(cuda_device, *out.shape, seed=5)
    tf, tb = {}, {}
    out_t, ms_t = ca.attn_heads_fwd_cuda(q, k, v, bias, mask, scale,
                                         save_ms=True, taps=tf)
    assert torch.equal(out_t, out) and torch.equal(ms_t, ms)
    e_want, dl_want = bc.heads_attention_bf16_intermediates(
        q, k, v, bias, mask, ms, g, scale)
    _within_one_bf16_ulp("forward e", tf["e"], e_want)
    _within_one_bf16_ulp("out from the kernel's e", out,
                         bc.heads_attention_bf16_fwd_stage(v, ms, tf["e"]))
    got = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)
    tapped = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale,
                                    taps=tb)
    assert all(torch.equal(p, r) for p, r in zip(got, tapped))
    _within_one_bf16_ulp("backward e", tb["e"], e_want)
    _assert_grad("dl", tb["dl"], dl_want)
    for name, p, r in zip(("dq", "dk", "dv"), got,
                          bc.heads_attention_bf16_bwd_stages(
                              q, k, ms, g, tb["e"], tb["dl"], scale)):
        _within_one_bf16_ulp(f"{name} from the kernel's e and dl", p, r)
    wq, wk, wv, wb = ca.heads_attention_bf16_backward_reference(
        q, k, v, bias, mask, ms, g, scale)
    slack = bc.heads_attention_bf16_slack(q, k, v, bias, mask, ms, g, scale)
    for name, p, r, sl in zip(("out", "dq", "dk", "dv"), (out,) + got[:3],
                              (want, wq, wk, wv), slack):
        bc.assert_bf16_mostly_within(name, p, r, sl)
    assert got[3].dtype == torch.float32
    _assert_grad("dbias", got[3], wb)
    again = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)
    assert all(torch.equal(p, r) for p, r in zip(again, got))
    fwd = launches_of(lambda: ca.attn_heads_fwd_cuda(q, k, v, bias, mask,
                                                     scale))
    assert fwd == {"attn_fwd_dense_bf16_kernel": 1}, fwd
    # the dense backward forms q k^T by the forward's products
    assert torch.equal(tf["e"], tb["e"])
    bwd = launches_of(lambda: ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms,
                                                     g, scale))
    split = ca.bwd_split(case["b_"], case["nh"], cuda_device)
    assert bwd.get("attn_bwd_bf16_kernel") == 1, bwd
    assert bwd.get("dkv_sum_kernel<__nv_bfloat16>", 0) == (split > 1), bwd
    assert bwd.get(ca.dense_dbias_reduce_kernel(q.shape[1],
                                                case["nh"])) == 1, bwd
    assert sum(bwd.values()) == 2 + (split > 1), bwd


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("case", SWIN_T_ATTN_BF16[:4], ids=str)
def test_packed_attention_bf16_takes_swin_t_heads(cuda_device, case,
                                                  compact):
    """The bfloat16 packed pair at Swin-T's head counts (3, 6, 12, 24):
    out and dqkv as the card's end-to-end check holds them, dbias to
    GRAD_REL."""
    from vitta_tpu_torch.tools import bf16_checks as bc
    qkv, vc, mask, wd = _attn_case(cuda_device, **case)
    qkv = qkv.to(BF16)
    nh, hd = case["nh"], case["hd"]
    scale = hd ** -0.5
    bias = vc if compact else cuda_bias.expand_bias_reference(vc, wd)
    ca = cuda_attention
    out, ms = ca.attn_packed_fwd_cuda(qkv, bias, mask, scale, nh,
                                      save_ms=True)
    want = ca.packed_attention_bf16_reference(qkv, bias, mask, scale, nh)
    g = _bf16_randn(cuda_device, *out.shape, seed=5)
    dqkv, dbias = ca.attn_packed_bwd_cuda(qkv, bias, mask, ms, g, scale, nh)
    wq, wb = ca.packed_attention_bf16_backward_reference(qkv, bias, mask, ms,
                                                         g, scale, nh)
    s_out, s_dqkv = bc.packed_attention_bf16_slack(qkv, bias, mask, ms, g,
                                                   scale, nh)
    bc.assert_bf16_mostly_within("out", out, want, s_out)
    bc.assert_bf16_mostly_within("dqkv", dqkv, wq, s_dqkv)
    _assert_grad("dbias", dbias, wb)


@pytest.mark.cuda
def test_bf16_swin_t_kernels_refuse_unaligned_views(cuda_device):
    """The bfloat16 MLP and heads kernels move 16-byte units of 8 values
    and refuse a view 2 bytes past a 16-byte boundary; q, k, v of mixed
    dtypes, and float32 weights beside bfloat16 x, are refused."""
    x, _g, _bt, w1, b1, w2, b2 = _bf16_mlp_case(cuda_device, 24, 16)
    buf = torch.empty(x.numel() + 1, dtype=BF16, device=cuda_device)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte"):
        cuda_mlp.mlp(xs, w1, b1, w2, b2)
    with pytest.raises(TypeError):
        cuda_mlp.mlp(x, w1.float(), b1, w2, b2)
    q, k, v, bias, mask, scale = _heads_case(cuda_device, "views", 6, 3, 8,
                                             (2, 3, 3), 3)
    qkv = torch.stack([q, k, v], dim=2).to(BF16)
    buf = torch.empty(qkv.numel() + 1, dtype=BF16, device=cuda_device)
    shifted = buf[1:].view(qkv.shape)
    shifted.copy_(qkv)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_attention.window_attention_heads(*shifted.unbind(2), bias, mask,
                                              scale)
    qb, kb, vb = qkv.unbind(2)
    with pytest.raises(TypeError):
        cuda_attention.window_attention_heads(qb, kb.float(), vb, bias, mask,
                                              scale)
    with pytest.raises(TypeError):            # the bias stays float32
        cuda_attention.window_attention_heads(qb, kb, vb, bias.to(BF16),
                                              mask, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mlp", "heads"])
def test_bf16_swin_t_ops_differentiate_through_their_kernels(cuda_device,
                                                             op):
    """Under autograd the bfloat16 ``mlp`` and ``window_attention_heads``
    run their forward and backward kernel once each and return bfloat16
    gradients for bfloat16 inputs (float32 for the bias); the heads op on
    views of one packed tensor gives that tensor's gradient, copying
    nothing."""
    from vitta_tpu_torch.models import swin
    dev = cuda_device
    if op == "mlp":
        x, _g, _bt, w1, b1, w2, b2 = _bf16_mlp_case(dev, 24, 16)
        ins, names = [x, w1, b1, w2, b2], ("mlp_fwd", "mlp_bwd")
        fn, mod = cuda_mlp.mlp, cuda_mlp
    else:
        qkv, vc, mask, wd = _attn_case(dev, 6, 3, 8, (2, 3, 3), 3)
        ins = [qkv.to(BF16), cuda_bias.expand_bias_reference(vc, wd)]
        names, mod = ("heads_fwd", "heads_bwd"), cuda_attention

        def fn(a, b):
            return cuda_attention.window_attention_heads(
                *a.reshape(6, 18, 3, 3, 8).unbind(2), b, mask, 8 ** -0.5)
    ins = [t.requires_grad_() for t in ins]
    mod.counters.reset()
    swin.counters.reset()
    out = fn(*ins)
    assert out.dtype == BF16
    out.float().sum().backward()
    assert tuple(getattr(mod.counters, n) for n in names) == (1, 1)
    assert swin.counters.contiguity_copies == 0
    for t in ins:
        assert t.grad is not None and t.grad.dtype == t.dtype


@pytest.mark.cuda
def test_bf16_swin_t_runs_through_the_kernels(cuda_device):
    """A Swin of Swin-T's widths at bfloat16 under each route, tapped
    forward and backward: every MLP through the bfloat16 ``mlp`` kernels,
    every attention through the bfloat16 packed or heads kernels (the
    wrappers' counters and the libraries' counts), no float32 MLP or
    attention kernel."""
    from vitta_tpu_torch.models.layers import Taps
    from vitta_tpu_torch.models.swin import Recognizer3D
    for route in ("packed", "heads"):
        torch.manual_seed(0)
        model = Recognizer3D(5, window_size=(2, 3, 3), embed_dim=96,
                             depths=(2, 1), num_heads=(3, 6),
                             attn_route=route, dtype="bfloat16").to(
                                 cuda_device)
        x = torch.randn(2, 4, 48, 48, 3, device=cuda_device)
        cuda_mlp.counters.reset()
        cuda_attention.counters.reset()

        def step():
            taps = Taps({"stat"})
            logits = model(x, taps, train=True)
            (logits.sum() + sum(v["stat"].var.sum() for v in taps.values())
             ).backward()
        names = launches_of(step)
        mc, ac = cuda_mlp.counters, cuda_attention.counters
        assert (mc.mlp_fwd, mc.mlp_bwd, mc.fwd, mc.bwd) == (3, 3, 0, 0)
        heads = route == "heads"
        assert (ac.heads_fwd, ac.heads_bwd) == ((3, 3) if heads else (0, 0))
        assert (ac.fwd, ac.bwd) == ((0, 0) if heads else (3, 3))
        for part in ("attn_fwd_kernel", "attn_bwd_kernel", "gemm_tiles<"):
            assert not any(part in k for k in names), names
        # the fused MLP without the LayerNorm: 1 launch a forward, the row
        # pass, dw1 and dw2 in one gemm_wgmma_bf16 launch and one reduce a
        # backward
        assert sum(n for k, n in names.items()
                   if k.startswith("mlp_rows_bf16<")) == 3 * (1 + 1), names
        assert sum(n for k, n in names.items()
                   if "gemm_wgmma_bf16" in k) == 3 * 1, names
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in model.parameters())


@pytest.mark.cuda
def test_bf16_swin_refuses_what_is_not_ported(cuda_device):
    """At bfloat16 every route builds (the projection-fused ones, rows
    16-19, since their bfloat16 kernels exist), and so do the widths whose
    norm2 runs apart (rows 8-9); float16 is refused."""
    for route in ("packed", "heads", "proj", "ln_proj"):
        _bf16_swin(cuda_device, route=route)
    _bf16_swin(cuda_device, embed_dim=96)
    from vitta_tpu_torch.models.swin import Recognizer3D
    with pytest.raises(ValueError):
        Recognizer3D(5, window_size=(2, 3, 3), embed_dim=128, depths=(2, 1),
                     num_heads=(4, 8), dtype="float16")


# --------------------------------------------------------------------------
# bfloat16: the projection-fused attention (rows 16-19) in the bfloat16 Swin
# under "proj" and "ln_proj", against its plain versions by
# vitta_tpu_torch/tools/bf16_checks.py:check_proj_bf16: each step on the
# kernel's own rounded intermediates (qkv and o_att, and g_att, dqkv, dl and
# dy from the backward's scratch), qkv and out by the Dense bound
# (``assert_dense_within``), the attention end to end as the packed one,
# the float32 intermediates and sums to 2e-5 of their largest magnitude;
# the launches the library's count and within the chain's budget.  Every
# Swin-B and Swin-T stage shape at 2 clips (with the mask where the
# stage's shifted blocks take it) and a small window.
SWIN_PROJ_BF16 = [dict(b_=b_, nh=nh, hd=32, window=(8, 7, 7), nw=nw)
                  for b_, nw, heads in ((128, 64, (4, 3)), (32, 16, (8, 6)),
                                        (8, 4, (16, 12)), (2, 0, (32, 24)))
                  for nh in heads]
SWIN_PROJ_BF16 += [dict(b_=6, nh=2, hd=16, window=(2, 3, 3), nw=3)]


def _bf16_proj_case(device, b_, nh, hd, window, nw):
    x, gm, bt, w, dense, mask, scale = _proj_case(device, b_, nh, hd, window,
                                                  nw)
    g = _bf16_randn(device, *x.shape, seed=21)
    gy = _bf16_randn(device, *x.shape, seed=22, scale=0.3)
    return (x.to(BF16), gm, bt, tuple(t.to(BF16) for t in w), dense, mask,
            scale, g, gy)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["proj", "ln_proj", "ln_proj, no gy"])
@pytest.mark.parametrize("case", SWIN_PROJ_BF16, ids=str)
def test_proj_bf16_kernels_match_plain(cuda_device, case, op):
    from vitta_tpu_torch.tools import bf16_checks as bc
    x, gm, bt, w, dense, mask, scale, g, gy = _bf16_proj_case(cuda_device,
                                                             **case)
    ln = None if op == "proj" else (gm, bt, 1e-5)
    got = bc.check_proj_bf16(x, ln, *w, dense, mask, scale, case["nh"], g,
                             gy if op == "ln_proj" else None)
    assert all(t.dtype == BF16 for t in got["grads"][:1])
    assert got["grads"][-1].dtype == torch.float32
    assert got["launches"][0] == (3 if ln is None else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(50176, 128), (12544, 256), (3136, 512),
                                 (784, 1024), (50176, 96), (784, 768),
                                 (108, 32)], ids=str)
def test_proj_bf16_plan_matches_the_kernels(cuda_device, m, c):
    cp = cuda_attention_proj
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert cp.bf16_gemm_plan_cuda(m, c) == cp.bf16_gemm_plan(m, c, sms)


# (b_, n, nh, nw, vec) of the dense bfloat16 forward's plan: every Swin
# stage at 2 clips, with and without the mask, and the tests' windows
DENSE_FWD_PLANS = [(128, 392, 3, 64, 1), (128, 392, 4, 0, 1),
                   (32, 392, 6, 16, 1), (8, 392, 16, 4, 1),
                   (2, 392, 24, 0, 1), (2, 392, 32, 0, 1), (6, 18, 3, 3, 0),
                   (4, 75, 2, 2, 0), (2, 416, 4, 0, 1), (4, 30, 2, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b_,n,nh,nw,vec", DENSE_FWD_PLANS, ids=str)
def test_dense_fwd_bf16_plan_matches_the_kernels(cuda_device, b_, n, nh, nw,
                                                 vec):
    """The library's dense-bias forward plan (vitta_attn_dense_fwd_bf16_plan)
    is cuda_attention.dense_fwd_bf16_plan on this card's SMs."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (cuda_attention.dense_fwd_bf16_plan_cuda(b_, n, nh, nw, vec,
                                                    cuda_device)
            == cuda_attention.dense_fwd_bf16_plan(b_, n, nh, nw, vec, sms))


@pytest.mark.cuda
@pytest.mark.parametrize("with_mask", [False, True])
def test_dense_fwd_bf16_takes_unaligned_bias_and_mask(cuda_device,
                                                      with_mask):
    """A bias and mask 4 bytes past a 16-byte boundary take the dense
    forward's 4-byte copies and reads, and give the bits of the aligned
    ones (the same arithmetic)."""
    ca = cuda_attention
    q, k, v, bias, mask, scale = _heads_case(
        cuda_device, "views", b_=8, nh=3, hd=32, window=(8, 7, 7),
        nw=4 if with_mask else 0)
    q, k, v = torch.stack([q, k, v], dim=2).to(BF16).unbind(2)

    def shifted(t):
        if t is None:
            return None
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    sb, sm = shifted(bias), shifted(mask)
    assert sb.data_ptr() % 16 == 4
    want = ca.attn_heads_fwd_cuda(q, k, v, bias, mask, scale, save_ms=True)
    got = ca.attn_heads_fwd_cuda(q, k, v, sb, sm, scale, save_ms=True)
    assert all(torch.equal(p, r) for p, r in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(b_=8, nh=3, hd=32, window=(8, 7, 7), nw=4),
    dict(b_=2, nh=24, hd=32, window=(8, 7, 7), nw=0),
    dict(b_=6, nh=3, hd=8, window=(2, 3, 3), nw=3),
    dict(b_=5, nh=1, hd=16, window=(1, 3, 3), nw=0),
    dict(b_=17, nh=2, hd=16, window=(2, 3, 3), nw=0)], ids=str)
def test_dense_bwd_bf16_dbias_is_window_order_in_graph_replays(cuda_device,
                                                               case):
    """The dense backward's dbias is its own dl added in window order from
    zero, to the bit, 4 floats a thread (dbias_reduce_x4_kernel) or one
    (nh N N = 81: dbias_reduce_kernel), and stays so over repeated calls
    and two calls in one CUDA graph, replayed twice."""
    ca = cuda_attention
    q, k, v, bias, mask, scale = _heads_case(cuda_device, "views", **case)
    q, k, v = torch.stack([q, k, v], dim=2).to(BF16).unbind(2)
    _out, ms = ca.attn_heads_fwd_cuda(q, k, v, bias, mask, scale,
                                      save_ms=True)
    g = torch.randn(q.shape, device=cuda_device).to(BF16)
    tb = {}
    tapped = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale,
                                    taps=tb)
    assert torch.equal(tapped[3], ca.dbias_in_window_order(tb["dl"], bias))
    got = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)
    assert all(torch.equal(p, r) for p, r in zip(got, tapped))
    bwd = launches_of(lambda: ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms,
                                                     g, scale))
    n = q.shape[1]
    assert bwd.get(ca.dense_dbias_reduce_kernel(n, case["nh"])) == 1, bwd
    assert (bwd.get("dbias_reduce_x4_kernel", 0)
            == (case["nh"] * n * n % 4 == 0)), bwd
    torch.cuda.synchronize(cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)  # warm-up
        with torch.cuda.graph(graph, stream=stream):
            first = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)
            second = ca.attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    for _ in range(2):
        for t in first + second:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize(cuda_device)
        for outs in (first, second):
            assert all(torch.equal(p, r) for p, r in zip(outs, got))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["proj", "ln_proj"])
def test_bf16_swin_proj_runs_through_the_kernels(cuda_device, route):
    """A bfloat16 Swin under the projection-fused routes, tapped forward
    and backward: every block through the route's bfloat16 op (the
    wrappers' counters), no packed or float32 attention kernel and no
    float32 product (the libraries' counts), every gradient of a float32
    master float32; under "ln_proj" the blocks' norm1 inside the op."""
    from vitta_tpu_torch.models.layers import Taps
    model = _bf16_swin(cuda_device, route=route)
    x = torch.randn(2, 4, 48, 48, 3, device=cuda_device)
    pc = cuda_attention_proj.counters
    pc.reset()
    cuda_attention.counters.reset()

    def step():
        taps = Taps({"stat"})
        logits = model(x, taps, train=True)
        (logits.sum() + sum(v["stat"].var.sum() for v in taps.values())
         ).backward()
    names = launches_of(step)
    fused = (pc.proj_fwd, pc.proj_bwd, pc.ln_proj_fwd, pc.ln_proj_bwd)
    assert fused == ((3, 3, 0, 0) if route == "proj" else (0, 0, 3, 3))
    ac = cuda_attention.counters
    assert (ac.fwd, ac.bwd, ac.heads_fwd, ac.heads_bwd) == (0, 0, 0, 0)
    for part in ("attn_fwd_kernel", "attn_bwd_kernel", "gemm_tiles<"):
        assert not any(part in k for k in names), names
    assert names.get("attn_fwd_dense_bf16_kernel") == 3, names
    assert names.get("attn_bwd_bf16_kernel") == 3, names
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


@pytest.mark.cuda
def test_proj_bf16_kernels_refuse_what_they_do_not_take(cuda_device):
    """No fallback: a view 2 bytes off a 16-byte boundary, a head dim that
    is no multiple of 8 and a float32 weight beside a bfloat16 x raise."""
    cp = cuda_attention_proj
    x, gm, bt, w, dense, mask, scale, g, _gy = _bf16_proj_case(
        cuda_device, b_=6, nh=2, hd=16, window=(2, 3, 3), nw=3)
    off = torch.empty(x.numel() + 1, dtype=BF16, device=cuda_device)[1:]
    off = off.view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        cp.attn_proj_fwd(off, *w, dense, mask, scale, 2)
    with pytest.raises(TypeError):
        cp.attn_proj_fwd(x, w[0].float(), *w[1:], dense, mask, scale, 2)
    x12, _gm, _bt, w12, dense12, _m, s12, _g, _gy = _bf16_proj_case(
        cuda_device, b_=4, nh=2, hd=12, window=(2, 3, 3), nw=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        cp.attn_proj_fwd(x12, *w12, dense12, None, s12, 2)


# ---------------------------------------------------------------------------
# The bfloat16 LayerNorm backward and TAM backward in 16-byte units: one
# launch a call, the blocks' sums finished by the blocks that draw the last
# tickets (csrc/tickets.cuh).  Their plans against the mirrors the CPU tests
# follow, and their bits over repeats, another stream and CUDA-graph
# replays (every launch leaves the tickets it drew at 0).

SWIN_LN_BF16_SITES = [(50176, 128), (12544, 256), (12544, 512), (3136, 512),
                      (3136, 1024), (784, 1024), (784, 2048), (50176, 96),
                      (12544, 384), (12544, 192), (3136, 768), (3136, 384),
                      (784, 1536), (784, 768), (7, 8), (33, 24), (1, 40)]
TANET_TAM_SITES = [(n, t, p, c) for p, c in ((3136, 64), (3136, 128),
                                             (784, 128), (784, 256),
                                             (196, 256), (196, 512),
                                             (49, 512))
                   for n, t in ((2, 16), (1, 16), (2, 3))] + [
                       (2, 5, 35, 24), (3, 40, 7, 8)]


@pytest.mark.cuda
def test_ln_bwd_bf16_plan_is_the_mirror(cuda_device):
    """csrc/ln.cu's plan of ln_bwd_bf16x8 against ``cuda_ln.
    ln_bwd_bf16_plan`` at the clusters the card holds of the instance, at
    every Swin-B and Swin-T site of the adapt batch and odd widths."""
    for rows, c in SWIN_LN_BF16_SITES:
        own = cuda_ln.ln_bwd_bf16_plan_cuda(rows, c)
        resident, sms = own.pop("resident"), own.pop("sms")
        assert resident >= 1 and sms >= 1
        assert own == cuda_ln.ln_bwd_bf16_plan(rows, c, resident, sms), \
            (rows, c)


@pytest.mark.cuda
def test_ln_fwd_bf16_plan_is_the_mirror(cuda_device):
    """csrc/ln_rows.cuh's plan of ln_fwd_bf16x8 against ``cuda_ln.
    ln_fwd_bf16_plan`` at the blocks of the instance an SM holds, at every
    Swin-B and Swin-T site at 1 and 2 clips and odd widths; widths the
    kernel does not take have no plan (units 0)."""
    sites = SWIN_LN_BF16_SITES + [(rows // 2, c)
                                  for rows, c in SWIN_LN_BF16_SITES
                                  if rows > 1]
    for rows, c in sites + [(5, 1040), (9, 1800)]:
        own = cuda_ln.ln_fwd_bf16_plan_cuda(rows, c)
        per_sm, sms = own.pop("per_sm"), own.pop("sms")
        assert per_sm >= 1 and sms >= 1
        assert own == cuda_ln.ln_fwd_bf16_plan(rows, c, per_sm, sms), \
            (rows, c)
    for rows, c in ((8, 100), (8, 2056), (0, 128)):
        assert cuda_ln.ln_fwd_bf16_plan_cuda(rows, c)["units"] == 0


@pytest.mark.cuda
def test_tam_bwd_bf16_plan_is_the_mirror(cuda_device):
    """csrc/tam.cu's plan of tam_bwd_bf16x8_kernel against ``cuda_tam.
    bwd_plan_bf16`` on the card's SMs, at every TANet site (adapt batch,
    one clip, three frames) and odd sizes."""
    for n, t, p, c in TANET_TAM_SITES:
        own = cuda_tam.bwd_plan_bf16_cuda(n, t, p, c)
        sms = own.pop("sms")
        assert own == cuda_tam.bwd_plan_bf16(n, t, p, c, sms), (n, t, p, c)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ln", "tam"])
def test_bf16_backward_repeats_and_graph_replays_are_bit_equal(cuda_device,
                                                               op):
    """Three calls in a row, one on another stream (its own slot of
    tickets), then a CUDA graph of the call replayed twice, then an eager
    call again: the same bits each time, one launch a call."""
    if op == "ln":
        x = (_randn(cuda_device, 3136, 512, seed=1, scale=2.0)
             + 0.5).to(BF16)
        g = _randn(cuda_device, 512, seed=2)
        dy = _bf16_randn(cuda_device, 3136, 512, seed=3)
        run = lambda: cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    else:
        x, attn, kernel, cot = _bf16_tam_inputs(cuda_device, n=2, t=16,
                                                h=28, w=28, c=128)
        run = lambda: cuda_tam.tam_bwd_cuda(cot, x, attn, kernel)
    assert sum(launches_of(run).values()) == 1

    def assert_equal(got, want):
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    first = run()
    for _ in range(2):
        assert_equal(run(), first)
    side = torch.cuda.Stream(cuda_device)    # warm-up before a capture
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        assert_equal(run(), first)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        assert_equal(captured, first)
    assert_equal(run(), first)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", SWIN_LN_BF16_SITES, ids=str)
def test_ln_bwd_bf16_at_the_swin_sites(cuda_device, rows, c):
    """ln_bwd_bf16x8 at every Swin-B and Swin-T site of the adapt batch
    (and odd widths) against ``layer_norm_backward_reference``: dx within
    one bfloat16 ulp, dgamma and dbeta within GRAD_REL of their largest
    value; one launch; two calls bit-equal."""
    x = (_randn(cuda_device, rows, c, seed=1, scale=2.0) + 0.5).to(BF16)
    g = _randn(cuda_device, c, seed=2)
    dy = _bf16_randn(cuda_device, rows, c, seed=3)
    names = launches_of(lambda: cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5))
    assert len(names) == 1 and sum(names.values()) == 1, names
    assert next(iter(names)).startswith("ln_bwd_bf16x8<"), names
    got = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
    _within_one_bf16_ulp("dx", got[0], want[0])
    _assert_grad("dgamma", got[1], want[1])
    _assert_grad("dbeta", got[2], want[2])
    again = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---------------------------------------------------------------------------
# The loader's Prefetcher (vitta_tpu_torch/data/pipeline.py) on the card:
# pinned host memory, a copy stream a worker, the consumer's stream waiting
# on each item's event.

@pytest.mark.cuda
@pytest.mark.parametrize("n_workers", [1, 3])
def test_prefetcher_copies_to_the_card_in_order(cuda_device, n_workers):
    """Every item's arrays arrive on the card, in index order, equal to the
    dataset's numpy arrays, and stay equal after later items were copied
    (their memory is not handed to a worker's stream while in use)."""
    from vitta_tpu_torch.data.pipeline import Prefetcher

    class Items:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return (rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8),
                    rng.normal(size=(1, 4, 8)).astype(np.float32),
                    np.asarray([i], np.int32))

    data = Items()
    got = []
    for i, (views, clip, label) in enumerate(
            Prefetcher(data, prefetch=3, n_workers=n_workers, start=1)):
        assert views.device.type == clip.device.type == "cuda"
        assert int(label[0]) == i + 1
        # work on the consumer's stream right after the copy
        got.append((views.float().sum(), clip * 2, views))
    torch.cuda.synchronize()
    assert len(got) == len(data) - 1
    for i, (total, clip2, views) in enumerate(got):
        want_v, want_c, _ = data[i + 1]
        assert float(total) == float(want_v.astype(np.float64).sum())
        np.testing.assert_array_equal(clip2.cpu().numpy(), want_c * 2)
        np.testing.assert_array_equal(views.cpu().numpy(), want_v)


# ---------------------------------------------------------------------------
# Video Swin's layout variants on the card (VITTA_WINDOW_RESIDENT,
# VITTA_PATCHIFY_V2): the same kernels a pass as the default form


def _swin_launch_counts():
    from vitta_tpu_torch.models import swin
    out = {}
    for mod in (cuda_ln, cuda_bias, cuda_attention, cuda_attention_proj,
                cuda_mlp, swin):
        for name in mod.counters._names:
            out[f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"] = getattr(
                mod.counters, name)
    return out


def _reset_swin_launch_counts():
    from vitta_tpu_torch.models import swin
    for mod in (cuda_ln, cuda_bias, cuda_attention, cuda_attention_proj,
                cuda_mlp, swin):
        mod.counters.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["packed", "heads", "ln_proj"])
def test_swin_layout_variants_on_the_card(cuda_device, float32_matmul,
                                          monkeypatch, dtype, route):
    """A small Swin (embed 128, depths (2, 1), window (2, 3, 3), 4 x 48²:
    both stages shift H and W), tapped forward and backward, in the
    default form and with the window-resident stages and the product patch
    embedding: both stages in window layout, no contiguity copy; the same
    kernel launches by wrapper.  Values against the default form's: at float32 logits and taps
    rtol / atol 2e-5 and every gradient within 5e-4 of its largest value
    (tests/test_torch_swin_layouts.py's bounds); at bfloat16, where the
    product patch embedding rounds some outputs the other way and the
    difference runs through the blocks, every one within 2e-2 of its
    largest value, the bound of the bfloat16 slices' eval logits
    (chip_smoke.py ``_assert_bf16_slice``; the CPU's plain versions read
    0.9% for the gradients, 4e-4 for the logits)."""
    from vitta_tpu_torch.models.layers import Taps
    from vitta_tpu_torch.models.swin import Recognizer3D
    # the Conv3d in float32, as the product that replaces it
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    forms = {"default": {}, "variants": dict(VITTA_WINDOW_RESIDENT="1",
                                             VITTA_PATCHIFY_V2="1")}
    x = _randn(cuda_device, 2, 4, 48, 48, 3, seed=7)
    runs = {}
    for form, env in forms.items():
        for name in ("VITTA_WINDOW_RESIDENT", "VITTA_PATCHIFY_V2"):
            monkeypatch.setenv(name, env.get(name, "0"))
        torch.manual_seed(0)
        model = Recognizer3D(5, window_size=(2, 3, 3), embed_dim=128,
                             depths=(2, 1), num_heads=(4, 8),
                             drop_path_rate=0.0, attn_route=route,
                             dtype=dtype).to(cuda_device)
        _reset_swin_launch_counts()
        taps = Taps({"stat"})
        logits = model(x, taps, train=True)
        loss = (logits.float() ** 2).sum() + sum(
            v["stat"].mean.sum() + v["stat"].var.sum() for v in taps.values())
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        runs[form] = (logits.detach().float(), taps, grads,
                      _swin_launch_counts())
    base_logits, base_taps, base_grads, base_counts = runs.pop("default")
    assert base_counts["swin.window_resident_stages"] == 0
    bf16 = dtype == "bfloat16"
    for form, (logits, taps, grads, counts) in runs.items():
        assert counts.pop("swin.window_resident_stages") == 2, form
        want = {k: n for k, n in base_counts.items()
                if k != "swin.window_resident_stages"}
        assert counts == want, form
        assert counts["swin.contiguity_copies"] == 0, form
        pairs = [("logits", logits, base_logits)] + [
            (f"tap {name}", a, b) for name, slot in base_taps.items()
            for a, b in zip(taps[name]["stat"], slot["stat"])]
        for what, a, b in pairs:
            if bf16:
                _assert_grad(f"{form} {what}", a, b, rel=2e-2)
            else:
                torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        for i, (a, b) in enumerate(zip(grads, base_grads)):
            _assert_grad(f"{form} gradient {i}", a, b,
                         rel=2e-2 if bf16 else 5e-4)
