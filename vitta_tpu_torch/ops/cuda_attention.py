"""Window attention, packed and per (head, window), forward and backward:
CUDA kernels, plain versions, autograd wrappers.

Per window b and head h, on the packed qkv projection output (B_, N, 3C)
whose last axis is ordered (3, nh, hd):

    out = softmax(scale * q k^T + bias[h] + mask[b mod nW]) v   -> (B_, N, C)

``window_attention_packed`` sends a CPU tensor to the plain PyTorch version
(``attention_reference`` on the unpacked views, the counterpart of
vitta_tpu/ops/pallas_attention.py:42, under torch's own autograd) and a
CUDA tensor to the hand-written kernels in
``vitta_tpu_torch/csrc/attention.cu``, the counterparts of
pallas_attention.py:403-454 (forward) and :457-527 (backward).  The bias is
the dense (nh, N, N) tensor or its Toeplitz slices (nh, 2wd-1, hw, hw)
(ops/cuda_bias.py); the kernels read either, and the backward returns the
bias's cotangent in the form the bias came in.  When a gradient is wanted
the forward keeps (qkv, bias, mask, ms), ms being the softmax row maximum
and sum (B_, N, 2nh) (pallas_attention.py:442, :638-641), and the backward
recomputes the softmax from them; ``packed_attention_backward_reference``
is its plain version.

``window_attention_heads`` is the same function on separate q, k, v
(B_, N, nh, hd) with a dense bias, the counterpart of
``fused_window_attention`` (pallas_attention.py:214), which vitta_tpu takes
where its packed kernel does not fit; ``attention_reference`` is its plain
forward and ``heads_attention_backward_reference`` its plain backward.  Its
kernels (the counterparts of pallas_attention.py:83 and :91) read q, k and
v where they lie, through three strides each, so views of the packed
projection output cost no copy.  The JAX op keeps (q, k, v, bias, mask)
and its backward rebuilds the softmax from the logits
(pallas_attention.py:198-200); this one also keeps the row maximum and sum
its forward kernel wrote, as the packed op does, so that its backward
kernel is the packed one's on strided rows and rebuilds nothing.  The op's
inputs and outputs are the JAX op's; the backward returns dq, dk, dv as
three tensors and a dense dbias.

The backward kernel computes its five matrix products on the tensor cores
in split TF32 (each float32 operand a sum of two tf32 values, three tf32
products per product), which keeps float32's accuracy
(tests/test_torch_attention_tf32.py emulates it on the CPU).

The mask has no gradient.  There is no fallback: a CUDA tensor a kernel
does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, check_tensor,
                                         contiguous_counted, grad_wanted,
                                         raise_on)
from vitta_tpu_torch.ops.cuda_bias import (collapse_bias_reference,
                                           expand_bias_reference)

# fwd, bwd: the packed kernels; heads_fwd, heads_bwd: those per (head, window)
counters = LaunchCounters("fwd", "bwd", "heads_fwd", "heads_bwd")


def attention_reference(q, k, v, bias, mask, scale: float):
    """The unfused model math (swin_transformer.py:138-169).

    q, k, v: (B_, N, nh, hd); bias (nh, N, N); mask (nW, N, N) or None;
    returns (B_, N, nh, hd)."""
    b_, n, nh, _ = q.shape
    attn = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    attn = attn + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
        attn = attn.reshape(b_, nh, n, n)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _dense(bias):
    if bias.dim() == 4:
        return expand_bias_reference(bias, (bias.shape[1] + 1) // 2)
    return bias


def packed_attention_reference(qkv, bias, mask, scale: float, nh: int,
                               save_ms: bool = False):
    """``attention_reference`` on the views of the packed tensor; with
    ``save_ms`` also the logits' row maximum and the sum of
    exp(logit - maximum), interleaved per head as (B_, N, 2nh)."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    q5 = qkv.reshape(b_, n, 3, nh, c // nh)
    bias = _dense(bias)
    out = attention_reference(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], bias,
                              mask, scale).reshape(b_, n, c)
    if not save_ms:
        return out
    logits = torch.einsum("bqhd,bkhd->bhqk", q5[:, :, 0] * scale,
                          q5[:, :, 1]) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b_ // nw, nw, nh, n, n)
                  + mask[None, :, None]).reshape(b_, nh, n, n)
    m = logits.max(dim=-1).values                               # (B_, nh, N)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    ms = torch.stack([m, s], dim=-1).permute(0, 2, 1, 3)        # (B_, N, nh, 2)
    return out, ms.reshape(b_, n, 2 * nh).contiguous()


def packed_attention_backward_reference(qkv, bias, mask, ms, g, scale: float,
                                        nh: int):
    """(dqkv (B_, N, 3C), dbias in the bias's form) for the cotangent ``g``
    (B_, N, C) of the attention output, written out from what the forward
    keeps as the kernel computes it (pallas_attention.py:457-514): the
    softmax is rebuilt from ``ms``."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    q5 = qkv.reshape(b_, n, 3, nh, hd)
    q, k, v = q5[:, :, 0], q5[:, :, 1], q5[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + _dense(bias)[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b_ // nw, nw, nh, n, n)
                  + mask[None, :, None]).reshape(b_, nh, n, n)
    ms4 = ms.reshape(b_, n, nh, 2).permute(0, 2, 1, 3)          # (B_, nh, N, 2)
    p = torch.exp(logits - ms4[..., 0:1]) / ms4[..., 1:2]
    gh = g.reshape(b_, n, nh, hd)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    dl = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q) * scale
    dbias = dl.sum(dim=0)
    if bias.dim() == 4:
        dbias = collapse_bias_reference(dbias, (bias.shape[1] + 1) // 2)
    return torch.stack([dq, dk, dv], dim=2).reshape(b_, n, c3), dbias


def heads_attention_backward_reference(q, k, v, bias, mask, g, scale: float):
    """(dq, dk, dv, dbias) for the cotangent ``g`` (B_, N, nh, hd) of the
    attention output, written out from (q, k, v, bias, mask) as the TPU
    kernel computes it (pallas_attention.py:91-124): the softmax is rebuilt
    from the logits.  The CUDA kernel reads the row maximum and sum its
    forward wrote instead, those of the same logits."""
    b_, n, nh, _ = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b_ // nw, nw, nh, n, n)
                  + mask[None, :, None]).reshape(b_, nh, n, n)
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    dl = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q) * scale
    return dq, dk, dv, dl.sum(dim=0)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vitta_attn_packed_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                              i, i, ctypes.c_float, p]
        lib.vitta_attn_packed_fwd.restype = i
        lib.vitta_attn_packed_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                              i, i, i, i, i, ctypes.c_float, p]
        lib.vitta_attn_packed_bwd.restype = i
        lib.vitta_attn_bwd_scratch_floats.argtypes = [i, i, i, i]
        lib.vitta_attn_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_attn_bwd_split.argtypes = [i, i]
        lib.vitta_attn_bwd_split.restype = i
        ll = ctypes.POINTER(ctypes.c_longlong)
        lib.vitta_attn_heads_fwd.argtypes = [p, p, p, ll, p, p, p, p, i, i, i,
                                             i, i, ctypes.c_float, p]
        lib.vitta_attn_heads_fwd.restype = i
        lib.vitta_attn_heads_bwd.argtypes = [p, p, p, ll] + [p] * 9 + [
            i, i, i, i, i, ctypes.c_float, p]
        lib.vitta_attn_heads_bwd.restype = i
        lib.vitta_attn_max_tokens.restype = i
        lib.vitta_attn_max_head_dim.restype = i
        lib.vitta_attn_max_row_stride.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _check(qkv, bias, mask, nh: int):
    """Raise on anything the kernels do not take; return
    (B_, N, C, hd, compact, wd, hw, nW)."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * nh) != 0:
        raise ValueError(f"qkv must be (B_, N, 3*nh*hd) with nh={nh}, got "
                         f"shape {tuple(qkv.shape)}")
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    dev = qkv.device
    check_tensor("window attention", "qkv", qkv, (b_, n, c3), dev)
    compact = bias.dim() == 4
    wd = hw = 0
    if compact:
        wd, hw = (bias.shape[1] + 1) // 2, bias.shape[-1]
        check_tensor("window attention", "bias", bias,
                     (nh, 2 * wd - 1, hw, hw), dev)
        if wd * hw != n:
            raise ValueError(f"compact bias of a {wd}x{hw}-token window for "
                             f"N={n}")
    else:
        check_tensor("window attention", "bias", bias, (nh, n, n), dev)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check_tensor("window attention", "mask", mask, (nw, n, n), dev)
        if b_ % nw != 0:
            raise ValueError(f"{b_} windows are not a multiple of the "
                             f"mask's {nw}")
    lib = _lib()
    if n > lib.vitta_attn_max_tokens() or hd > lib.vitta_attn_max_head_dim():
        raise ValueError(
            f"the window attention kernels take N <= "
            f"{lib.vitta_attn_max_tokens()} and hd <= "
            f"{lib.vitta_attn_max_head_dim()}; got N={n}, hd={hd}")
    return b_, n, c, hd, compact, wd, hw, nw


def attn_packed_fwd_cuda(qkv, bias, mask, scale: float, nh: int,
                         save_ms: bool = False):
    """Forward kernel: one launch; returns out (B_, N, C), and ms
    (B_, N, 2nh) with ``save_ms``."""
    b_, n, c, hd, compact, wd, hw, nw = _check(qkv, bias, mask, nh)
    dev = qkv.device
    lib = _lib()
    out = torch.empty((b_, n, c), dtype=torch.float32, device=dev)
    ms = torch.empty((b_, n, 2 * nh), dtype=torch.float32,
                     device=dev) if save_ms else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.vitta_attn_packed_fwd(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if ms is None else ms.data_ptr(), b_, n, nh, hd, nw,
            int(compact), wd, hw, float(scale), stream)
    raise_on(code, "window attention forward kernel")
    counters.fwd += 1
    return (out, ms) if save_ms else out


def bwd_split(b_: int, nh: int, device=None) -> int:
    """Blocks that share one (window, head) problem in the backward kernel
    on ``device``'s card: 1 unless the problems are fewer than its SMs."""
    with torch.cuda.device(device):
        return _lib().vitta_attn_bwd_split(b_, nh)


def _bwd_scratch(b_, n, nh, hd, dev):
    """The backward's scratch (the bias cotangent of every window, B_*nh*N*N
    floats, and the blocks' shares of dk and dv where they share a
    problem), sized on ``dev``'s card."""
    with torch.cuda.device(dev):
        floats = _lib().vitta_attn_bwd_scratch_floats(b_, n, nh, hd)
    return torch.empty(floats, dtype=torch.float32, device=dev)


def attn_packed_bwd_cuda(qkv, bias, mask, ms, g, scale: float, nh: int):
    """Backward kernels: one wrapper call, two to three launches on the
    current stream (the kernel, the sum of the blocks' shares of dk and dv
    where problems are shared, the sum of dl over the windows); returns
    (dqkv (B_, N, 3C), dbias in the bias's form), allocated here with the
    scratch."""
    b_, n, c, hd, compact, wd, hw, nw = _check(qkv, bias, mask, nh)
    dev = qkv.device
    check_tensor("window attention", "ms", ms, (b_, n, 2 * nh), dev)
    check_tensor("window attention", "grad", g, (b_, n, c), dev)
    lib = _lib()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    scratch = _bwd_scratch(b_, n, nh, hd, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.vitta_attn_packed_bwd(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), ms.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
            scratch.data_ptr(), b_, n, nh, hd, nw, int(compact), wd, hw,
            float(scale), stream)
    raise_on(code, "window attention backward kernel")
    counters.bwd += 1
    return dqkv, dbias


class PackedWindowAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op (the counterpart of the
    custom VJP at pallas_attention.py:633-652).  With ``keep`` the forward
    has the kernel emit the row maximum and sum and keeps (qkv, bias,
    mask, ms); without it nothing is kept.  A strided cotangent is copied
    once, and counted."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, nh, save_ms, keep):
        ctx.scale, ctx.nh = scale, nh
        res = attn_packed_fwd_cuda(qkv, bias, mask, scale, nh,
                                   save_ms or keep)
        out, ms = res if (save_ms or keep) else (res, None)
        if keep:
            ctx.save_for_backward(qkv, bias, mask, ms)
        if not save_ms:
            return out
        ctx.mark_non_differentiable(ms)
        return out, ms

    @staticmethod
    def backward(ctx, g, g_ms=None):
        qkv, bias, mask, ms = ctx.saved_tensors
        dqkv, dbias = attn_packed_bwd_cuda(qkv, bias, mask, ms,
                                           contiguous_counted(g), ctx.scale,
                                           ctx.nh)
        return dqkv, dbias, None, None, None, None, None


def window_attention_packed(qkv, bias, mask, scale: float, nh: int,
                            save_ms: bool = False):
    """Window attention on packed ``qkv`` (B_, N, 3C) -> (B_, N, C), the
    input layout of the output projection; ``(out, ms)`` with ``save_ms``.

    bias: dense (nh, N, N) or compact (nh, 2wd-1, hw, hw); mask (nW, N, N)
    of 0 / -100 or None.  A CPU tensor takes the plain version; a CUDA
    tensor takes the kernels (forward, and backward under autograd), which
    raise on any dtype other than float32, a non-contiguous input, N > 416
    or hd > 32."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, bias, mask, scale, nh, save_ms)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window attention for device {qkv.device}")
    return PackedWindowAttention.apply(qkv, bias, mask, float(scale), nh,
                                       save_ms, grad_wanted(qkv, bias))


def _check_heads(q, k, v, bias, mask):
    """Raise on anything the per-(head, window) kernels do not take; return
    (B_, N, nh, hd, nW, the nine strides as a ctypes array).  q, k and v
    may be strided views as long as each head's channels are contiguous."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B_, N, nh, hd), got shape "
                         f"{tuple(q.shape)}")
    b_, n, nh, hd = q.shape
    dev = q.device
    strides = []
    for name, ten in (("q", q), ("k", k), ("v", v)):
        check_tensor("window attention", name, ten, (b_, n, nh, hd), dev,
                     contiguous=False)
        if ten.stride(3) != 1 and hd > 1:
            raise ValueError(f"{name}: the channels of a head must be "
                             f"contiguous, got strides {ten.stride()}")
        strides += [ten.stride(0), ten.stride(1), ten.stride(2)]
    check_tensor("window attention", "bias", bias, (nh, n, n), dev)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check_tensor("window attention", "mask", mask, (nw, n, n), dev)
        if b_ % nw != 0:
            raise ValueError(f"{b_} windows are not a multiple of the "
                             f"mask's {nw}")
    lib = _lib()
    if n > lib.vitta_attn_max_tokens() or hd > lib.vitta_attn_max_head_dim():
        raise ValueError(
            f"the window attention kernels take N <= "
            f"{lib.vitta_attn_max_tokens()} and hd <= "
            f"{lib.vitta_attn_max_head_dim()}; got N={n}, hd={hd}")
    if max(strides[1::3]) > lib.vitta_attn_max_row_stride():
        raise ValueError(
            f"the window attention kernels take q, k, v whose tokens lie at "
            f"most {lib.vitta_attn_max_row_stride()} floats apart; got "
            f"strides {strides[1::3]}")
    return b_, n, nh, hd, nw, (ctypes.c_longlong * 9)(*strides)


def attn_heads_fwd_cuda(q, k, v, bias, mask, scale: float,
                        save_ms: bool = False):
    """Forward kernel per (head, window): one launch; returns out
    (B_, N, nh, hd), and ms (B_, N, 2nh) with ``save_ms``."""
    b_, n, nh, hd, nw, strides = _check_heads(q, k, v, bias, mask)
    dev = q.device
    out = torch.empty((b_, n, nh, hd), dtype=torch.float32, device=dev)
    ms = torch.empty((b_, n, 2 * nh), dtype=torch.float32,
                     device=dev) if save_ms else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = _lib().vitta_attn_heads_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), None if ms is None else ms.data_ptr(), b_, n, nh,
            hd, nw, float(scale), stream)
    raise_on(code, "window attention (heads) forward kernel")
    counters.heads_fwd += 1
    return (out, ms) if save_ms else out


def attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale: float):
    """Backward kernels per (head, window), from the row maximum and sum
    ``ms`` the forward wrote: one wrapper call, the packed backward's two to
    three launches on the current stream; returns (dq, dk, dv, each
    (B_, N, nh, hd) and contiguous, dbias (nh, N, N)), allocated here with
    the scratch."""
    b_, n, nh, hd, nw, strides = _check_heads(q, k, v, bias, mask)
    dev = q.device
    check_tensor("window attention", "ms", ms, (b_, n, 2 * nh), dev)
    check_tensor("window attention", "grad", g, (b_, n, nh, hd), dev)
    lib = _lib()
    dq, dk, dv = (torch.empty((b_, n, nh, hd), dtype=torch.float32,
                              device=dev) for _ in range(3))
    dbias = torch.empty_like(bias)
    scratch = _bwd_scratch(b_, n, nh, hd, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.vitta_attn_heads_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            ms.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(), scratch.data_ptr(), b_, n, nh,
            hd, nw, float(scale), stream)
    raise_on(code, "window attention (heads) backward kernel")
    counters.heads_bwd += 1
    return dq, dk, dv, dbias


class HeadsWindowAttention(torch.autograd.Function):
    """The kernel pair as one differentiable op (the counterpart of the
    custom VJP at pallas_attention.py:192-211).  With ``keep`` the forward
    has the kernel emit the row maximum and sum and keeps (q, k, v, bias,
    mask, ms); without it nothing is kept.  A strided cotangent is copied
    once, and counted."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, keep):
        ctx.scale = scale
        if not keep:
            return attn_heads_fwd_cuda(q, k, v, bias, mask, scale)
        out, ms = attn_heads_fwd_cuda(q, k, v, bias, mask, scale, True)
        ctx.save_for_backward(q, k, v, bias, mask, ms)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, ms = ctx.saved_tensors
        return attn_heads_bwd_cuda(q, k, v, bias, mask, ms,
                                   contiguous_counted(g),
                                   ctx.scale) + (None, None, None)


def window_attention_heads(q, k, v, bias, mask, scale: float):
    """Window attention on separate ``q``, ``k``, ``v`` (B_, N, nh, hd) ->
    (B_, N, nh, hd).

    bias: dense (nh, N, N); mask (nW, N, N) of 0 / -100 or None.  A CPU
    tensor takes the plain version; a CUDA tensor takes the kernels
    (forward, and backward under autograd), which read strided views where
    they lie and raise on any dtype other than float32, a head whose
    channels are not contiguous, N > 416 or hd > 32."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no window attention for device {q.device}")
    return HeadsWindowAttention.apply(q, k, v, bias, mask, float(scale),
                                      grad_wanted(q, k, v, bias))
