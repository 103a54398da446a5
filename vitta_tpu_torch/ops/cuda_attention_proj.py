"""Projection-fused window attention, with and without the LayerNorm
prologue, forward and backward: CUDA kernels, plain versions, autograd
wrappers.

On windows x (B_, N, C), with the weights in ``nn.Linear`` layout (wqkv
(3C, C), wproj (C, C)), the dense bias (nh, N, N) and the shift mask
(nW, N, N) of 0 / -100 or None:

    qkv = x wqkv^T + bqkv                     last axis ordered (3, nh, hd)
    o_att = softmax(scale q k^T + bias[h] + mask[b mod nW]) v     per head
    out = o_att wproj^T + bproj                                -> (B_, N, C)

``window_attention_proj`` computes that; ``window_attention_ln_proj`` first
normalizes x (one-pass float32 LayerNorm, gamma and beta) and returns
``(out, y)`` with y the LayerNorm output in window layout, which the norm1
statistic tap reads and whose cotangent re-enters the backward.  They are
the counterparts of vitta_tpu/ops/pallas_attention.py:1200 and :1159.

A CPU tensor takes the plain PyTorch versions (``proj_attention_reference``
and ``ln_proj_attention_reference``, under torch's own autograd) and a CUDA
tensor the hand-written kernels in ``vitta_tpu_torch/csrc/attention_proj.cu``,
the counterparts of pallas_attention.py:724-782 and :945-1016; every matrix
product on that path is the kernels' own.  When a gradient is wanted the
forward keeps what the JAX package keeps (pallas_attention.py:901-905,
:1125-1130): the inputs, o_att (B_, N, C) and ms, the softmax row maximum
and sum (B_, N, 2nh); the backward recomputes qkv (and y) from x.
``proj_attention_backward_reference`` and
``ln_proj_attention_backward_reference`` are its plain versions.  A
parameter that wants no gradient gets None and its launches are skipped.
The mask has no gradient.  There is no fallback: a CUDA tensor a kernel
does not take raises.

The scratch (qkv, its cotangent and the partial sums) comes from torch's
caching allocator inside each wrapper, on the input's device and current
stream, and is freed on return; the allocator hands it out again only to
work queued on the same stream behind the kernels that read it.  The port
runs everything on one stream.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops._launch import (LaunchCounters, check_tensor,
                                         contiguous_counted, grad_wanted,
                                         raise_on)
from vitta_tpu_torch.ops.cuda_attention import (
    packed_attention_backward_reference, packed_attention_reference)
from vitta_tpu_torch.ops.cuda_ln import (layer_norm_backward_reference,
                                         layer_norm_reference)

counters = LaunchCounters("proj_fwd", "proj_bwd", "ln_proj_fwd",
                          "ln_proj_bwd")

WHAT = "projection-fused window attention"


# ------------------------------------------------------------ plain versions
def proj_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                             scale: float, nh: int,
                             save_residuals: bool = False):
    """The unfused composition on ``x`` (B_, N, C); returns out, and with
    ``save_residuals`` (out, o_att, ms)."""
    qkv = F.linear(x, wqkv, bqkv)
    if not save_residuals:
        o_att = packed_attention_reference(qkv, bias, mask, scale, nh)
        return F.linear(o_att, wproj, bproj)
    o_att, ms = packed_attention_reference(qkv, bias, mask, scale, nh, True)
    return F.linear(o_att, wproj, bproj), o_att, ms


def proj_attention_backward_reference(x, wqkv, bqkv, wproj, bias, mask,
                                      o_att, ms, g, scale: float, nh: int):
    """(dx, dwqkv, dbqkv, dwproj, dbproj, dbias) for the cotangent ``g`` of
    out, written out from what the forward keeps as the kernel computes it
    (pallas_attention.py:747-782): qkv is recomputed from x."""
    c = x.shape[-1]
    g2, o2, x2 = g.reshape(-1, c), o_att.reshape(-1, c), x.reshape(-1, c)
    dwproj, dbproj = g2.t() @ o2, g2.sum(dim=0)
    g_att = g @ wproj
    qkv = F.linear(x, wqkv, bqkv)
    dqkv, dbias = packed_attention_backward_reference(qkv, bias, mask, ms,
                                                      g_att, scale, nh)
    d2 = dqkv.reshape(-1, 3 * c)
    return dqkv @ wqkv, d2.t() @ x2, d2.sum(dim=0), dwproj, dbproj, dbias


def ln_proj_attention_reference(x, gamma, beta, eps: float, wqkv, bqkv, wproj,
                                bproj, bias, mask, scale: float, nh: int,
                                save_residuals: bool = False):
    """LayerNorm, then ``proj_attention_reference``; returns (out, y), and
    with ``save_residuals`` (out, y, o_att, ms)."""
    y = layer_norm_reference(x, gamma, beta, eps)
    res = proj_attention_reference(y, wqkv, bqkv, wproj, bproj, bias, mask,
                                   scale, nh, save_residuals)
    return (res[0], y) + tuple(res[1:]) if save_residuals else (res, y)


def ln_proj_attention_backward_reference(x, gamma, beta, eps: float, wqkv,
                                         bqkv, wproj, bias, mask, o_att, ms,
                                         g, gy, scale: float, nh: int):
    """(dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias) for the
    cotangents ``g`` of out and ``gy`` of y (or None), as the kernel
    computes them (pallas_attention.py:967-1016): y and the row statistics
    are recomputed from x."""
    y = layer_norm_reference(x, gamma, beta, eps)
    dy, dwqkv, dbqkv, dwproj, dbproj, dbias = \
        proj_attention_backward_reference(y, wqkv, bqkv, wproj, bias, mask,
                                          o_att, ms, g, scale, nh)
    if gy is not None:
        dy = dy + gy
    c = x.shape[-1]
    dx, dgamma, dbeta = layer_norm_backward_reference(
        x.reshape(-1, c), gamma, dy.reshape(-1, c), eps)
    return (dx.reshape(x.shape), dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj,
            dbias)


# ------------------------------------------------------------------ kernels
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("attention_proj")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vitta_attn_proj_fwd.argtypes = [p] * 11 + [i] * 5 + [f, p]
        lib.vitta_attn_ln_proj_fwd.argtypes = [p] * 14 + [i] * 5 + [f, f, p]
        lib.vitta_attn_proj_bwd.argtypes = [p] * 16 + [i] * 5 + [f, p]
        lib.vitta_attn_ln_proj_bwd.argtypes = [p] * 20 + [i] * 5 + [f, f, p]
        for fn in (lib.vitta_attn_proj_fwd, lib.vitta_attn_ln_proj_fwd,
                   lib.vitta_attn_proj_bwd, lib.vitta_attn_ln_proj_bwd):
            fn.restype = i
        lib.vitta_attn_proj_fwd_scratch_floats.argtypes = [i] * 4
        lib.vitta_attn_proj_fwd_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_attn_proj_bwd_scratch_floats.argtypes = [i] * 5
        lib.vitta_attn_proj_bwd_scratch_floats.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


# the largest window and head size of the attention kernels
# (csrc/attention_kernels.cuh) and the row alignment of gemm_tiles
MAX_TOKENS, MAX_HEAD_DIM = 416, 32


def _check(x, nh: int, mask, named):
    """Raise on anything the kernels do not take; ``named`` lists (name,
    tensor, shape as a string over b, n, c, t (3c), h (nh), m (2nh)).
    Returns (B_, N, C, hd, nW)."""
    if x.dim() != 3 or x.shape[2] % nh != 0:
        raise ValueError(f"x must be (B_, N, nh*hd) with nh={nh}, got shape "
                         f"{tuple(x.shape)}")
    b_, n, c = x.shape
    hd = c // nh
    dims = {"b": b_, "n": n, "c": c, "t": 3 * c, "h": nh, "m": 2 * nh}
    for name, ten, shape in named:
        check_tensor(WHAT, name, ten, tuple(dims[d] for d in shape), x.device)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check_tensor(WHAT, "mask", mask, (nw, n, n), x.device)
        if b_ % nw != 0:
            raise ValueError(f"{b_} windows are not a multiple of the "
                             f"mask's {nw}")
    if b_ == 0 or n == 0:
        raise ValueError("x has no rows")
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM or c % 4 != 0:
        raise ValueError(
            f"the {WHAT} kernels take N <= {MAX_TOKENS}, hd <= "
            f"{MAX_HEAD_DIM} and C a multiple of 4; got N={n}, hd={hd}, "
            f"C={c}")
    return b_, n, c, hd, nw


def _ptr(t):
    return None if t is None else t.data_ptr()


_FWD_NAMED = (("wqkv", "tc"), ("bqkv", "t"), ("wproj", "cc"), ("bproj", "c"),
              ("bias", "hnn"))


def _fwd_cuda(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh,
              save_residuals):
    """Both forward entry points; ``ln`` is (gamma, beta, eps) or None."""
    named = [("x", x, "bnc")] + [
        (name, ten, shape) for (name, shape), ten in
        zip(_FWD_NAMED, (wqkv, bqkv, wproj, bproj, bias))]
    if ln is not None:
        named += [("gamma", ln[0], "c"), ("beta", ln[1], "c")]
    b_, n, c, hd, nw = _check(x, nh, mask, named)
    dev = x.device
    lib = _lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out, o_att = new(b_, n, c), new(b_, n, c)
    ms = new(b_, n, 2 * nh) if save_residuals else None
    scratch = new(lib.vitta_attn_proj_fwd_scratch_floats(b_, n, nh, hd))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if ln is None:
            y = None
            code = lib.vitta_attn_proj_fwd(
                x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(),
                _ptr(mask), o_att.data_ptr(), _ptr(ms), out.data_ptr(),
                scratch.data_ptr(), b_, n, nh, hd, nw, float(scale), stream)
        else:
            y = new(b_, n, c)
            code = lib.vitta_attn_ln_proj_fwd(
                x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
                wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
                bproj.data_ptr(), bias.data_ptr(), _ptr(mask), y.data_ptr(),
                o_att.data_ptr(), _ptr(ms), out.data_ptr(),
                scratch.data_ptr(), b_, n, nh, hd, nw, float(ln[2]),
                float(scale), stream)
    raise_on(code, f"{WHAT} forward kernel")
    return out, y, o_att, ms


def attn_proj_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask, scale: float,
                  nh: int, save_residuals: bool = False):
    """Forward kernels on ``x`` (B_, N, C): one wrapper call, three
    launches on the current stream; returns out, and with
    ``save_residuals`` (out, o_att, ms)."""
    out, _y, o_att, ms = _fwd_cuda(x, None, wqkv, bqkv, wproj, bproj, bias,
                                   mask, scale, nh, save_residuals)
    counters.proj_fwd += 1
    return (out, o_att, ms) if save_residuals else out


def attn_ln_proj_fwd(x, gamma, beta, eps: float, wqkv, bqkv, wproj, bproj,
                     bias, mask, scale: float, nh: int,
                     save_residuals: bool = False):
    """Forward kernels with the LayerNorm in front: four launches; returns
    (out, y), and with ``save_residuals`` (out, y, o_att, ms)."""
    out, y, o_att, ms = _fwd_cuda(x, (gamma, beta, eps), wqkv, bqkv, wproj,
                                  bproj, bias, mask, scale, nh,
                                  save_residuals)
    counters.ln_proj_fwd += 1
    return (out, y, o_att, ms) if save_residuals else (out, y)


# which of (dwqkv, dbqkv, dwproj, dbproj, dbias) a backward computes
ALL_GRADS = (True,) * 5


def _bwd_cuda(x, ln, wqkv, bqkv, wproj, bias, mask, o_att, ms, g, gy, scale,
              nh, want):
    named = [("x", x, "bnc"), ("wqkv", wqkv, "tc"), ("bqkv", bqkv, "t"),
             ("wproj", wproj, "cc"), ("bias", bias, "hnn"),
             ("o_att", o_att, "bnc"), ("ms", ms, "bnm"),
             ("grad of out", g, "bnc")]
    if ln is not None:
        named += [("gamma", ln[0], "c"), ("beta", ln[1], "c")]
    if gy is not None:
        named.append(("grad of y", gy, "bnc"))
    b_, n, c, hd, nw = _check(x, nh, mask, named)
    dev = x.device
    lib = _lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx = new(b_, n, c)
    shapes = ((3 * c, c), (3 * c,), (c, c), (c,), (nh, n, n))
    grads = [new(*s) if w else None for s, w in zip(shapes, want)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        # sized for this card: a problem's blocks depend on its SM count
        scratch = new(lib.vitta_attn_proj_bwd_scratch_floats(
            b_, n, nh, hd, int(ln is not None)))
        if ln is None:
            dgb = None
            code = lib.vitta_attn_proj_bwd(
                x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wproj.data_ptr(), bias.data_ptr(), _ptr(mask),
                o_att.data_ptr(), ms.data_ptr(), g.data_ptr(), dx.data_ptr(),
                *(_ptr(t) for t in grads), scratch.data_ptr(), b_, n, nh, hd,
                nw, float(scale), stream)
        else:
            dgb = new(2, c)
            code = lib.vitta_attn_ln_proj_bwd(
                x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
                wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
                bias.data_ptr(), _ptr(mask), o_att.data_ptr(), ms.data_ptr(),
                g.data_ptr(), _ptr(gy), dx.data_ptr(), dgb.data_ptr(),
                *(_ptr(t) for t in grads), scratch.data_ptr(), b_, n, nh, hd,
                nw, float(ln[2]), float(scale), stream)
    raise_on(code, f"{WHAT} backward kernel")
    return dx, dgb, grads


def attn_proj_bwd(x, wqkv, bqkv, wproj, bias, mask, o_att, ms, g,
                  scale: float, nh: int, want=ALL_GRADS):
    """Backward kernels: one wrapper call, its launches on the current
    stream.  Returns (dx, dwqkv, dbqkv, dwproj, dbproj, dbias), allocated
    here with the scratch; an entry whose ``want`` is False is None and is
    not computed."""
    dx, _dgb, grads = _bwd_cuda(x, None, wqkv, bqkv, wproj, bias, mask, o_att,
                                ms, g, None, scale, nh, want)
    counters.proj_bwd += 1
    return (dx, *grads)


def attn_ln_proj_bwd(x, gamma, beta, eps: float, wqkv, bqkv, wproj, bias,
                     mask, o_att, ms, g, gy, scale: float, nh: int,
                     want=ALL_GRADS):
    """Backward kernels through the LayerNorm; ``gy`` may be None (no
    cotangent on y).  Returns (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj,
    dbproj, dbias)."""
    dx, dgb, grads = _bwd_cuda(x, (gamma, beta, eps), wqkv, bqkv, wproj, bias,
                               mask, o_att, ms, g, gy, scale, nh, want)
    counters.ln_proj_bwd += 1
    return (dx, dgb[0], dgb[1], *grads)


# ----------------------------------------------------------------- autograd
class ProjWindowAttention(torch.autograd.Function):
    """The kernels as one differentiable op (the counterpart of the custom
    VJP at pallas_attention.py:895-919).  With ``keep`` the forward has
    the kernel emit ms and keeps (x, wqkv, bqkv, wproj, bias, mask, o_att,
    ms); without it nothing is kept.  A strided cotangent is copied once,
    and counted."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh,
                keep):
        ctx.scale, ctx.nh = scale, nh
        if not keep:
            return attn_proj_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                 scale, nh)
        out, o_att, ms = attn_proj_fwd(x, wqkv, bqkv, wproj, bproj, bias,
                                       mask, scale, nh, True)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bias, mask, o_att, ms)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wproj, bias, mask, o_att, ms = ctx.saved_tensors
        need = ctx.needs_input_grad
        want = (need[1], need[2], need[3], need[4], need[5])
        dx, dwqkv, dbqkv, dwproj, dbproj, dbias = attn_proj_bwd(
            x, wqkv, bqkv, wproj, bias, mask, o_att, ms,
            contiguous_counted(g), ctx.scale, ctx.nh, want)
        return (dx if need[0] else None, dwqkv, dbqkv, dwproj, dbproj, dbias,
                None, None, None, None)


class LnProjWindowAttention(torch.autograd.Function):
    """The LayerNorm form (the counterpart of the custom VJP at
    pallas_attention.py:1117-1146).  An output without a cotangent arrives
    as None, not as zeros."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                eps, scale, nh, keep):
        ctx.eps, ctx.scale, ctx.nh = eps, scale, nh
        ctx.set_materialize_grads(False)
        if not keep:
            return attn_ln_proj_fwd(x, gamma, beta, eps, wqkv, bqkv, wproj,
                                    bproj, bias, mask, scale, nh)
        out, y, o_att, ms = attn_ln_proj_fwd(x, gamma, beta, eps, wqkv, bqkv,
                                             wproj, bproj, bias, mask, scale,
                                             nh, True)
        ctx.save_for_backward(x, gamma, beta, wqkv, bqkv, wproj, bias, mask,
                              o_att, ms)
        return out, y

    @staticmethod
    def backward(ctx, g, gy):
        (x, gamma, beta, wqkv, bqkv, wproj, bias, mask, o_att,
         ms) = ctx.saved_tensors
        need = ctx.needs_input_grad
        want = (need[3], need[4], need[5], need[6], need[7])
        g = torch.zeros_like(x) if g is None else contiguous_counted(g)
        if gy is not None:
            gy = contiguous_counted(gy)
        (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj,
         dbias) = attn_ln_proj_bwd(x, gamma, beta, ctx.eps, wqkv, bqkv, wproj,
                                   bias, mask, o_att, ms, g, gy, ctx.scale,
                                   ctx.nh, want)
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, dwqkv, dbqkv, dwproj, dbproj,
                dbias, None, None, None, None, None)


def _device_kind(x) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {WHAT} for device {x.device}")
    return kind


def window_attention_proj(x, wqkv, bqkv, wproj, bproj, bias, mask,
                          scale: float, nh: int):
    """qkv projection + window attention + output projection on windows
    ``x`` (B_, N, C) -> (B_, N, C).

    wqkv (3C, C), bqkv (3C), wproj (C, C), bproj (C); bias dense
    (nh, N, N); mask (nW, N, N) of 0 / -100 or None.  A CPU tensor takes
    the plain version; a CUDA tensor takes the kernels (forward, and
    backward under autograd), which raise on any dtype other than float32,
    a non-contiguous input, N > 416, hd > 32 or a C that is no multiple of
    4."""
    if _device_kind(x) == "cpu":
        return proj_attention_reference(x, wqkv, bqkv, wproj, bproj, bias,
                                        mask, scale, nh)
    return ProjWindowAttention.apply(
        x, wqkv, bqkv, wproj, bproj, bias, mask, float(scale), nh,
        grad_wanted(x, wqkv, bqkv, wproj, bproj, bias))


def window_attention_ln_proj(x, gamma, beta, eps: float, wqkv, bqkv, wproj,
                             bproj, bias, mask, scale: float, nh: int):
    """``window_attention_proj`` on LayerNorm(x) over the last axis;
    returns ``(out, y)`` with y the LayerNorm output (B_, N, C).  Devices
    and limits as for ``window_attention_proj``."""
    if _device_kind(x) == "cpu":
        return ln_proj_attention_reference(x, gamma, beta, eps, wqkv, bqkv,
                                           wproj, bproj, bias, mask, scale,
                                           nh)
    return LnProjWindowAttention.apply(
        x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask, float(eps),
        float(scale), nh,
        grad_wanted(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias))
