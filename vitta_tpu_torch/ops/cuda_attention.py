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

At bfloat16 (``window_attention_packed`` only: qkv, out, the cotangent and
dqkv bfloat16; the bias, the mask, ms and dbias float32) the kernels are
``vitta_attn_packed_{fwd,bwd}_bf16``, the counterparts of the same Pallas
kernels at the compute dtype, with one bfloat16 tensor-core product per
fragment, and they round where those do (pallas_attention.py:358-514,
VJP :644-649): the logits (q k^T) * scale + bias + mask and the softmax's
e = exp(l - m) and sum are float32, e is rounded before e v, out = (e v) /
s once; the backward rounds gs = g / s before dv = e^T gs and dl before dq
and dk, keeps dl float32 for dbias, and rounds dq, dk and dv once.  Its
dbias is summed in vitta_tpu's order (``dbias_in_window_order``): each
window's dl, for the compact bias collapsed over the frame pairs in d1
order, then the windows in their order; with the compact bias the kernel
collapses on chip and writes (window, head) partials, never dl itself.
``packed_attention_bf16_reference`` and
``packed_attention_bf16_backward_reference`` are their plain versions, and
on the CPU a bfloat16 qkv runs them as one autograd Function
(``PackedAttentionPlain``).  ``window_attention_heads`` at bfloat16 (q, k,
v, out, the cotangent, dq, dk and dv bfloat16; the dense bias, the mask,
ms and dbias float32) runs ``vitta_attn_heads_{fwd,bwd}_bf16``, the
counterparts of pallas_attention.py:83 and :91 at the compute dtype, which
round at the same points: the same bfloat16 kernels on q, k and v where
they lie (three strides each, as the float32 heads pair reads them), with
the dense bias and its dense dbias, summed over the windows in their order
(pallas_attention.py:116-124).  ``heads_attention_bf16_reference`` and
``heads_attention_bf16_backward_reference`` are their plain versions, run
on the CPU as one autograd Function (``HeadsAttentionPlain``).  On the
dense bias (this route, the packed op given one, and the projection-fused
chains) the bfloat16 forward is a kernel of its own, which walks runs of
windows a block and sums s and o in its own fixed order;
``dense_fwd_bf16_plan`` is its plan, ``dense_fwd_bf16_plan_cuda`` the
library's.

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


def _bf16_logits_of(q, k, v, bias, mask, scale: float):
    """q, k, v (B_, N, nh, hd) as float32 and the logits (B_, nh, N, N),
    float32 as the bfloat16 kernels make them: (q k^T) * scale + bias +
    mask."""
    b_, n, nh, _ = q.shape
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + _dense(bias)[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b_ // nw, nw, nh, n, n)
                  + mask[None, :, None]).reshape(b_, nh, n, n)
    return q, k, v, logits


def _bf16_logits(qkv, bias, mask, scale: float, nh: int):
    """``_bf16_logits_of`` the packed bfloat16 ``qkv`` (B_, N, 3C)."""
    b_, n, c3 = qkv.shape
    q, k, v = qkv.reshape(b_, n, 3, nh, c3 // 3 // nh).to(
        torch.float32).unbind(2)
    return _bf16_logits_of(q, k, v, bias, mask, scale)


def _bf16_attend(v, logits):
    """(o (B_, N, nh, hd) float32 before its one rounding, ms (B_, N,
    2nh)) of the bfloat16 forward: e = exp(l - m) and its sum s in
    float32, o = (bfloat16(e) v) / s."""
    b_, nh, n, _ = logits.shape
    m = logits.amax(dim=-1)                                    # (B_, nh, N)
    e = torch.exp(logits - m[..., None])
    s = e.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).to(torch.float32),
                     v) / s.permute(0, 2, 1)[..., None]
    ms = torch.stack([m, s], dim=-1).permute(0, 2, 1, 3)       # (B_, N, nh, 2)
    return o, ms.reshape(b_, n, 2 * nh).contiguous()


def _bf16_attend_backward(q, k, v, logits, ms, gh, scale: float):
    """(dq, dk, dv (B_, N, nh, hd) float32 before their one rounding, dl
    (B_, nh, N, N) float32) of the bfloat16 backward from float32 q, k, v,
    the logits, the forward's ``ms`` and the float32 cotangent ``gh``: e
    from the row maximum, gs = bfloat16(g / s), dv = bfloat16(e)^T gs, dq
    and dk from bfloat16(dl)."""
    b_, n, nh, _ = q.shape
    f32, bf16 = torch.float32, torch.bfloat16
    ms4 = ms.reshape(b_, n, nh, 2).permute(0, 2, 1, 3)          # (B_, nh, N, 2)
    e = torch.exp(logits - ms4[..., 0:1])
    inv = 1.0 / ms4[..., 1:2]                                   # (B_, nh, N, 1)
    gs = (gh * inv.permute(0, 2, 1, 3)).to(bf16).to(f32)
    dv = torch.einsum("bhqk,bqhd->bkhd", e.to(bf16).to(f32), gs)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    rs = torch.sum(dp * e, dim=-1, keepdim=True) * inv
    dl = e * (dp - rs) * inv
    dlc = dl.to(bf16).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", dlc, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlc, q) * scale
    return dq, dk, dv, dl


def packed_attention_bf16_reference(qkv, bias, mask, scale: float, nh: int,
                                    save_ms: bool = False):
    """The packed attention at bfloat16 as the kernel computes it
    (pallas_attention.py:358-454 at the compute dtype): out bfloat16
    (B_, N, C), and with ``save_ms`` the float32 row maximum and sum of
    the logits' exp (B_, N, 2nh)."""
    b_, n, c3 = qkv.shape
    _q, _k, v, logits = _bf16_logits(qkv, bias, mask, scale, nh)
    o, ms = _bf16_attend(v, logits)
    out = o.reshape(b_, n, c3 // 3).to(qkv.dtype)
    return (out, ms) if save_ms else out


def packed_attention_bf16_backward_reference(qkv, bias, mask, ms, g,
                                             scale: float, nh: int):
    """(dqkv (B_, N, 3C) bfloat16, dbias float32 in the bias's form) at
    bfloat16, as the kernel computes it (pallas_attention.py:457-514 at the
    compute dtype): e from the forward's row maximum, gs = bfloat16(g / s),
    dv = bfloat16(e)^T gs, dl float32 (into dbias), dq and dk from
    bfloat16(dl)."""
    b_, n, c3 = qkv.shape
    q, k, v, logits = _bf16_logits(qkv, bias, mask, scale, nh)
    dq, dk, dv, dl = _bf16_attend_backward(
        q, k, v, logits, ms, g.reshape(q.shape).to(torch.float32), scale)
    return (torch.stack([dq, dk, dv], dim=2).reshape(b_, n, c3).to(qkv.dtype),
            dbias_in_window_order(dl, bias))


def heads_attention_bf16_reference(q, k, v, bias, mask, scale: float,
                                   save_ms: bool = False):
    """The attention per (head, window) at bfloat16 as its kernel computes
    it (pallas_attention.py:83-88 at the compute dtype): q, k, v bfloat16
    (B_, N, nh, hd), the dense bias and the mask float32; out bfloat16
    (B_, N, nh, hd), and with ``save_ms`` the float32 row maximum and sum of
    the logits' exp (B_, N, 2nh)."""
    q32, k32, v32, logits = _bf16_logits_of(q, k, v, bias, mask, scale)
    o, ms = _bf16_attend(v32, logits)
    out = o.to(q.dtype)
    return (out, ms) if save_ms else out


def heads_attention_bf16_backward_reference(q, k, v, bias, mask, ms, g,
                                            scale: float):
    """(dq, dk, dv bfloat16 (B_, N, nh, hd), dbias float32 (nh, N, N)) for
    the cotangent ``g`` (B_, N, nh, hd) at bfloat16, as the kernel computes
    them (pallas_attention.py:91-124 at the compute dtype) from the
    forward's row maximum and sum ``ms``, which the TPU kernel rebuilds from
    the same logits: gs = bfloat16(g / s), dv = bfloat16(e)^T gs, dl
    float32, dq and dk from bfloat16(dl), dbias the sum of dl over the
    windows in their order."""
    q32, k32, v32, logits = _bf16_logits_of(q, k, v, bias, mask, scale)
    dq, dk, dv, dl = _bf16_attend_backward(q32, k32, v32, logits, ms,
                                           g.to(torch.float32), scale)
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype),
            dbias_in_window_order(dl, bias))


def dbias_in_window_order(dl, bias):
    """dbias from dl (B_, nh, N, N) in the bias's form, in vitta_tpu's
    order (pallas_attention.py:384-400, :517-527): each window's dl, for
    the compact bias collapsed over its frame pairs in d1 order, added into
    a zero dbias window by window.  The bfloat16 backward kernel sums in
    this order (tests/test_torch_attention_bf16_order.py emulates how it
    makes its compact partials)."""
    part = dl
    if bias.dim() == 4:
        b_, nh, n, _ = dl.shape
        wd = (bias.shape[1] + 1) // 2
        part = collapse_bias_reference(dl.reshape(b_ * nh, n, n), wd)
        part = part.reshape(b_, nh, *part.shape[1:])
    dbias = torch.zeros_like(part[0])
    for window in part.unbind(0):
        dbias = dbias + window
    return dbias


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
        lib.vitta_attn_bwd_bf16_scratch_floats.argtypes = [i] * 8
        lib.vitta_attn_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
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
        # the float32 entries' arguments and e_tap before the stream
        lib.vitta_attn_packed_fwd_bf16.argtypes = \
            lib.vitta_attn_packed_fwd.argtypes[:-1] + [p, p]
        lib.vitta_attn_packed_fwd_bf16.restype = i
        lib.vitta_attn_packed_bwd_bf16.argtypes = \
            lib.vitta_attn_packed_bwd.argtypes[:-1] + [p, p]
        lib.vitta_attn_packed_bwd_bf16.restype = i
        lib.vitta_attn_heads_fwd_bf16.argtypes = \
            lib.vitta_attn_heads_fwd.argtypes[:-1] + [p, p]
        lib.vitta_attn_heads_fwd_bf16.restype = i
        lib.vitta_attn_heads_bwd_bf16.argtypes = \
            lib.vitta_attn_heads_bwd.argtypes[:-1] + [p, p]
        lib.vitta_attn_heads_bwd_bf16.restype = i
        lib.vitta_attn_dense_fwd_bf16_plan.argtypes = [i] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.vitta_attn_dense_fwd_bf16_plan.restype = None
        _LIB = lib
    return _LIB


def _check(qkv, bias, mask, nh: int):
    """Raise on anything the kernels do not take; return
    (B_, N, C, hd, compact, wd, hw, nW).  qkv float32 or bfloat16 (then on
    a 16-byte boundary, hd a multiple of 8); bias and mask float32."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * nh) != 0:
        raise ValueError(f"qkv must be (B_, N, 3*nh*hd) with nh={nh}, got "
                         f"shape {tuple(qkv.shape)}")
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    dev = qkv.device
    check_tensor("window attention", "qkv", qkv, (b_, n, c3), dev,
                 dtypes=(torch.float32, torch.bfloat16))
    if qkv.dtype == torch.bfloat16 and (qkv.data_ptr() % 16 or hd % 8):
        raise ValueError(f"the bfloat16 window attention kernels take a qkv "
                         f"on a 16-byte boundary and hd a multiple of 8; got "
                         f"hd={hd}, qkv {qkv.data_ptr() % 16} bytes past a "
                         f"boundary")
    compact = bias.dim() == 4
    if compact and qkv.dtype == torch.bfloat16 and bias.shape[1] > 31:
        raise ValueError(f"the bfloat16 window attention kernels take a "
                         f"compact bias of a window at most 16 frames deep, "
                         f"got {(bias.shape[1] + 1) // 2}")
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


def _e_tap(taps, qkv, b_, n, nh):
    """None, or the (B_, nh, N, N) bfloat16 tensor for the kernel's
    rounded e, kept in ``taps["e"]`` (a dict a check passes in)."""
    if taps is None:
        return None
    if qkv.dtype != torch.bfloat16:
        raise ValueError("taps are read from the bfloat16 kernels only")
    taps["e"] = torch.empty((b_, nh, n, n), dtype=torch.bfloat16,
                            device=qkv.device)
    return taps["e"]


def attn_packed_fwd_cuda(qkv, bias, mask, scale: float, nh: int,
                         save_ms: bool = False, taps=None):
    """Forward kernel: one launch; returns out (B_, N, C), and ms
    (B_, N, 2nh) with ``save_ms``.  ``taps``, a dict, at bfloat16 only:
    the kernel's instance that also writes bfloat16(e) runs, and
    ``taps["e"]`` (B_, nh, N, N) holds it, for a check."""
    b_, n, c, hd, compact, wd, hw, nw = _check(qkv, bias, mask, nh)
    dev = qkv.device
    lib = _lib()
    out = torch.empty((b_, n, c), dtype=qkv.dtype, device=dev)
    ms = torch.empty((b_, n, 2 * nh), dtype=torch.float32,
                     device=dev) if save_ms else None
    e_tap = _e_tap(taps, qkv, b_, n, nh)
    bf16 = qkv.dtype == torch.bfloat16
    fwd = lib.vitta_attn_packed_fwd_bf16 if bf16 else lib.vitta_attn_packed_fwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fwd(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if ms is None else ms.data_ptr(), b_, n, nh, hd, nw,
            int(compact), wd, hw, float(scale),
            *((None if e_tap is None else e_tap.data_ptr(),) if bf16 else ()),
            stream)
    raise_on(code, "window attention forward kernel")
    counters.fwd += 1
    return (out, ms) if save_ms else out


# csrc/attention_kernels.cuh: kLdB, kLdKV, kDenseRedLd, the dense forward's
# defaults and the shared memory a block may take
_LDB, _LDKV, _RED_LD = 40, 32, 36
_DENSE_SPLIT, _DENSE_MAX_WARPS, _DENSE_WAVES = 4, 16, 4
_SMEM_PER_BLOCK = 232448
DENSE_FWD_PLAN_KEYS = ("strips", "keys", "ldb", "slots", "bands", "run",
                       "runs", "vec", "blocks", "smem")


def dense_fwd_bf16_plan(b_: int, n: int, nh: int, nw: int, vec: bool,
                        sms: int = 132) -> dict:
    """The dense-bias bfloat16 forward kernel's plan, as ``dense_fwd_plan``
    in csrc/attention_kernels.cuh chooses it from the shape alone: ``b_``
    windows of ``n`` tokens, ``nh`` heads, ``nw`` masks (0 without one),
    ``vec`` where n % 4 == 0 and the bias and mask lie on 16-byte
    boundaries, ``sms`` the card's SMs.  A block takes ``slots`` of the
    problem's 16-row strips (strips b, b + bands, ... of band b), four
    warps each, for one head, and walks a run of ``run`` windows, whole
    groups of those that share a mask; it holds K in two buffers, V in one.
    Keys as DENSE_FWD_PLAN_KEYS."""
    strips = (n + 15) // 16
    keys = 16 * strips
    ldb = keys + 8
    kv = 3 * keys * _LDKV * 2
    per = 2 * 16 * _LDB * 2 + 16 * ldb * 4 + _DENSE_SPLIT * 16 * (
        _RED_LD + 2) * 4
    fit = max(1, min(strips, _DENSE_MAX_WARPS // _DENSE_SPLIT,
                     (_SMEM_PER_BLOCK - kv) // per))
    bands = -(-strips // fit)
    slots = -(-strips // bands)
    smem = kv + slots * per
    target = _DENSE_WAVES * sms * max(1, _SMEM_PER_BLOCK // smem)
    group = b_ // nw if nw > 0 else 1
    groups = b_ // group
    per_run = min(groups, max(1, nh * bands * groups // target))
    runs = -(-groups // per_run)
    run = group * -(-groups // runs)
    return dict(strips=strips, keys=keys, ldb=ldb, slots=slots, bands=bands,
                run=run, runs=runs, vec=int(bool(vec)),
                blocks=nh * bands * runs, smem=smem)


def dense_fwd_bf16_plan_cuda(b_: int, n: int, nh: int, nw: int, vec: bool,
                             device=None) -> dict:
    """The plan the library's dense forward takes on ``device``'s card
    (``vitta_attn_dense_fwd_bf16_plan``), keyed as
    ``dense_fwd_bf16_plan``'s."""
    out = (ctypes.c_int * len(DENSE_FWD_PLAN_KEYS))()
    with torch.cuda.device(device):
        _lib().vitta_attn_dense_fwd_bf16_plan(b_, n, nh, nw, int(bool(vec)),
                                              out)
    return dict(zip(DENSE_FWD_PLAN_KEYS, out))


def dense_dbias_reduce_kernel(n: int, nh: int) -> str:
    """The launch that sums the bfloat16 dense backward's dl over the
    windows (csrc/attention_kernels.cuh, launch_dense_dbias_reduce) on the
    port's 16-byte aligned tensors: 4 floats a thread where nh N N is a
    multiple of 4, else one.  Both add the windows in vitta_tpu's order."""
    return ("dbias_reduce_x4_kernel" if nh * n * n % 4 == 0
            else "dbias_reduce_kernel")


def bwd_split(b_: int, nh: int, device=None) -> int:
    """Blocks that share one (window, head) problem in the backward kernel
    on ``device``'s card: 1 unless the problems are fewer than its SMs."""
    with torch.cuda.device(device):
        return _lib().vitta_attn_bwd_split(b_, nh)


def bwd_scratch_floats(b_: int, n: int, nh: int, hd: int, dtype,
                       compact: bool = False, wd: int = 0, hw: int = 0,
                       tap: bool = False, device=None) -> int:
    """Floats of the backward's scratch on ``device``'s card.  float32: the
    bias cotangent of every window (B_*nh*N*N) and the blocks' shares of dk
    and dv where they share a problem.  bfloat16: dl (B_*nh*N*N) only with
    the dense bias or a ``tap``, the (window, head) partials of the compact
    dbias (B_*nh*(2wd-1)*hw*hw), and the same shares."""
    with torch.cuda.device(device):
        if dtype == torch.bfloat16:
            return _lib().vitta_attn_bwd_bf16_scratch_floats(
                b_, n, nh, hd, int(compact), wd, hw, int(tap))
        return _lib().vitta_attn_bwd_scratch_floats(b_, n, nh, hd)


def _bwd_scratch(b_, n, nh, hd, dev, dtype=torch.float32, compact=False,
                 wd=0, hw=0, tap=False):
    """The backward's scratch (``bwd_scratch_floats``) on ``dev``."""
    floats = bwd_scratch_floats(b_, n, nh, hd, dtype, compact, wd, hw, tap,
                                dev)
    return torch.empty(floats, dtype=torch.float32, device=dev)


def attn_packed_bwd_cuda(qkv, bias, mask, ms, g, scale: float, nh: int,
                         taps=None):
    """Backward kernels: one wrapper call, two to three launches on the
    current stream (the kernel, the sum of the blocks' shares of dk and dv
    where problems are shared, the sum over the windows of dl, or at
    bfloat16 with the compact bias of the windows' compact partials);
    returns (dqkv (B_, N, 3C), dbias in the bias's form), allocated here
    with the scratch (``bwd_scratch_floats``).  ``taps``, a dict, at
    bfloat16 only: ``taps["e"]`` holds the kernel's bfloat16(e) as
    ``attn_packed_fwd_cuda`` does, and ``taps["dl"]`` (B_, nh, N, N)
    float32 its dl, the scratch's first B_*nh*N*N floats."""
    b_, n, c, hd, compact, wd, hw, nw = _check(qkv, bias, mask, nh)
    dev = qkv.device
    check_tensor("window attention", "ms", ms, (b_, n, 2 * nh), dev)
    check_tensor("window attention", "grad", g, (b_, n, c), dev,
                 dtypes=(qkv.dtype,))
    if g.data_ptr() % 16:
        raise ValueError("the window attention kernels take a cotangent on "
                         "a 16-byte boundary")
    lib = _lib()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    scratch = _bwd_scratch(b_, n, nh, hd, dev, qkv.dtype, compact, wd, hw,
                           taps is not None)
    e_tap = _e_tap(taps, qkv, b_, n, nh)
    bf16 = qkv.dtype == torch.bfloat16
    bwd = lib.vitta_attn_packed_bwd_bf16 if bf16 else lib.vitta_attn_packed_bwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = bwd(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), ms.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
            scratch.data_ptr(), b_, n, nh, hd, nw, int(compact), wd, hw,
            float(scale),
            *((None if e_tap is None else e_tap.data_ptr(),) if bf16 else ()),
            stream)
    raise_on(code, "window attention backward kernel")
    if taps is not None:
        taps["dl"] = scratch[:b_ * nh * n * n].view(b_, nh, n, n)
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


class PackedAttentionPlain(torch.autograd.Function):
    """The bfloat16 plain forward and plain backward as one differentiable
    op, the CPU's form at bfloat16: it rounds where the kernels round."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, nh):
        ctx.scale, ctx.nh = scale, nh
        out, ms = packed_attention_bf16_reference(qkv, bias, mask, scale, nh,
                                                  save_ms=True)
        ctx.save_for_backward(qkv, bias, mask, ms)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, mask, ms = ctx.saved_tensors
        dqkv, dbias = packed_attention_bf16_backward_reference(
            qkv, bias, mask, ms, g, ctx.scale, ctx.nh)
        return dqkv, dbias, None, None, None


def window_attention_packed(qkv, bias, mask, scale: float, nh: int,
                            save_ms: bool = False):
    """Window attention on packed ``qkv`` (B_, N, 3C) -> (B_, N, C), the
    input layout of the output projection; ``(out, ms)`` with ``save_ms``.

    bias: dense (nh, N, N) or compact (nh, 2wd-1, hw, hw); mask (nW, N, N)
    of 0 / -100 or None.  A CPU tensor takes the plain version; a CUDA
    tensor takes the kernels (forward, and backward under autograd), which
    raise on a qkv other than float32 or bfloat16 (bias and mask float32),
    a non-contiguous input, N > 416 or hd > 32.  At bfloat16 the CPU takes
    the bfloat16 plain versions, forward and backward
    (``PackedAttentionPlain``)."""
    if qkv.device.type == "cpu":
        if qkv.dtype == torch.bfloat16:
            if save_ms or not grad_wanted(qkv, bias):
                return packed_attention_bf16_reference(qkv, bias, mask, scale,
                                                       nh, save_ms)
            return PackedAttentionPlain.apply(qkv, bias, mask, float(scale),
                                              nh)
        return packed_attention_reference(qkv, bias, mask, scale, nh, save_ms)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window attention for device {qkv.device}")
    return PackedWindowAttention.apply(qkv, bias, mask, float(scale), nh,
                                       save_ms, grad_wanted(qkv, bias))


def _check_heads(q, k, v, bias, mask):
    """Raise on anything the per-(head, window) kernels do not take; return
    (B_, N, nh, hd, nW, the nine strides as a ctypes array).  q, k and v
    float32 or bfloat16, all three the same; they may be strided views as
    long as each head's channels are contiguous, at bfloat16 with every
    stride a multiple of 8 values, each base on a 16-byte boundary and hd
    a multiple of 8."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B_, N, nh, hd), got shape "
                         f"{tuple(q.shape)}")
    b_, n, nh, hd = q.shape
    dev = q.device
    dtype = q.dtype if q.dtype == torch.bfloat16 else torch.float32
    strides = []
    for name, ten in (("q", q), ("k", k), ("v", v)):
        check_tensor("window attention", name, ten, (b_, n, nh, hd), dev,
                     contiguous=False, dtypes=(dtype,))
        if ten.stride(3) != 1 and hd > 1:
            raise ValueError(f"{name}: the channels of a head must be "
                             f"contiguous, got strides {ten.stride()}")
        if dtype == torch.bfloat16 and (
                ten.data_ptr() % 16 or hd % 8
                or any(st % 8 for st in ten.stride()[:3])):
            raise ValueError(
                f"the bfloat16 window attention kernels take q, k, v on "
                f"16-byte boundaries, strides that are multiples of 8 and hd "
                f"a multiple of 8; {name} lies {ten.data_ptr() % 16} bytes "
                f"past a boundary with strides {ten.stride()}, hd={hd}")
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
            f"most {lib.vitta_attn_max_row_stride()} values apart; got "
            f"strides {strides[1::3]}")
    return b_, n, nh, hd, nw, (ctypes.c_longlong * 9)(*strides)


def attn_heads_fwd_cuda(q, k, v, bias, mask, scale: float,
                        save_ms: bool = False, taps=None):
    """Forward kernel per (head, window): one launch; returns out
    (B_, N, nh, hd) at q's dtype, and ms (B_, N, 2nh) with ``save_ms``.
    ``taps``, a dict, at bfloat16 only: as ``attn_packed_fwd_cuda``'s,
    ``taps["e"]`` holds the kernel's bfloat16(e)."""
    b_, n, nh, hd, nw, strides = _check_heads(q, k, v, bias, mask)
    dev = q.device
    out = torch.empty((b_, n, nh, hd), dtype=q.dtype, device=dev)
    ms = torch.empty((b_, n, 2 * nh), dtype=torch.float32,
                     device=dev) if save_ms else None
    e_tap = _e_tap(taps, q, b_, n, nh)
    lib = _lib()
    bf16 = q.dtype == torch.bfloat16
    fwd = lib.vitta_attn_heads_fwd_bf16 if bf16 else lib.vitta_attn_heads_fwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), None if ms is None else ms.data_ptr(), b_, n, nh,
            hd, nw, float(scale),
            *((None if e_tap is None else e_tap.data_ptr(),) if bf16 else ()),
            stream)
    raise_on(code, "window attention (heads) forward kernel")
    counters.heads_fwd += 1
    return (out, ms) if save_ms else out


def attn_heads_bwd_cuda(q, k, v, bias, mask, ms, g, scale: float, taps=None):
    """Backward kernels per (head, window), from the row maximum and sum
    ``ms`` the forward wrote: one wrapper call, the packed backward's two to
    three launches on the current stream; returns (dq, dk, dv, each
    (B_, N, nh, hd), contiguous and at q's dtype, dbias (nh, N, N)
    float32), allocated here with the scratch.  ``taps``, a dict, at
    bfloat16 only: ``taps["e"]`` and ``taps["dl"]`` as
    ``attn_packed_bwd_cuda`` fills them."""
    b_, n, nh, hd, nw, strides = _check_heads(q, k, v, bias, mask)
    dev = q.device
    check_tensor("window attention", "ms", ms, (b_, n, 2 * nh), dev)
    check_tensor("window attention", "grad", g, (b_, n, nh, hd), dev,
                 dtypes=(q.dtype,))
    bf16 = q.dtype == torch.bfloat16
    if bf16 and g.data_ptr() % 16:
        raise ValueError("the bfloat16 window attention kernels take a "
                         "cotangent on a 16-byte boundary")
    lib = _lib()
    dq, dk, dv = (torch.empty((b_, n, nh, hd), dtype=q.dtype, device=dev)
                  for _ in range(3))
    dbias = torch.empty_like(bias)
    scratch = _bwd_scratch(b_, n, nh, hd, dev, q.dtype, tap=taps is not None)
    e_tap = _e_tap(taps, q, b_, n, nh)
    bwd = lib.vitta_attn_heads_bwd_bf16 if bf16 else lib.vitta_attn_heads_bwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            ms.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(), scratch.data_ptr(), b_, n, nh,
            hd, nw, float(scale),
            *((None if e_tap is None else e_tap.data_ptr(),) if bf16 else ()),
            stream)
    raise_on(code, "window attention (heads) backward kernel")
    if taps is not None:
        taps["dl"] = scratch[:b_ * nh * n * n].view(b_, nh, n, n)
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


class HeadsAttentionPlain(torch.autograd.Function):
    """The bfloat16 plain forward and plain backward per (head, window) as
    one differentiable op, the CPU's form at bfloat16: it rounds where the
    kernels round."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.scale = scale
        out, ms = heads_attention_bf16_reference(q, k, v, bias, mask, scale,
                                                 save_ms=True)
        ctx.save_for_backward(q, k, v, bias, mask, ms)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, ms = ctx.saved_tensors
        return heads_attention_bf16_backward_reference(
            q, k, v, bias, mask, ms, g, ctx.scale) + (None, None)


def window_attention_heads(q, k, v, bias, mask, scale: float):
    """Window attention on separate ``q``, ``k``, ``v`` (B_, N, nh, hd) ->
    (B_, N, nh, hd).

    bias: dense (nh, N, N); mask (nW, N, N) of 0 / -100 or None.  A CPU
    tensor takes the plain version (at bfloat16 the bfloat16 plain
    versions, forward and backward, ``HeadsAttentionPlain``); a CUDA tensor
    takes the kernels (forward, and backward under autograd), which read
    strided views where they lie and raise on q, k, v other than all
    float32 or all bfloat16 (bias and mask float32), a head whose channels
    are not contiguous, N > 416 or hd > 32, and at bfloat16 a view off a
    16-byte boundary."""
    if q.device.type == "cpu":
        if q.dtype != torch.bfloat16:
            return attention_reference(q, k, v, bias, mask, scale)
        if grad_wanted(q, k, v, bias):
            return HeadsAttentionPlain.apply(q, k, v, bias, mask,
                                             float(scale))
        return heads_attention_bf16_reference(q, k, v, bias, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no window attention for device {q.device}")
    return HeadsWindowAttention.apply(q, k, v, bias, mask, float(scale),
                                      grad_wanted(q, k, v, bias))
