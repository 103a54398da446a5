"""Fused LayerNorm -> MLP, forward and backward: CUDA kernels, plain
versions, autograd wrapper.

    y = LayerNorm(x) * gamma + beta;  o = fc2(gelu(fc1(y)))   (exact GELU)

over the last axis, returning ``(o, y)``: ``y`` is the LayerNorm output
that the norm2 statistic tap reads.  The weights are in ``nn.Linear``
layout, w1 (F, C) and w2 (C, F).  ``ln_mlp`` sends a CPU tensor to the
plain PyTorch version (``ln_mlp_reference``, the counterpart of
vitta_tpu/ops/pallas_mlp.py:618, under torch's own autograd) and a CUDA
tensor to the hand-written kernels in ``vitta_tpu_torch/csrc/mlp.cu``, the
counterparts of pallas_mlp.py:303-319 (forward) and :322-369 (backward);
all six matrix products are the kernels' own.  When a gradient is wanted
the forward keeps (x, y, a, s, gamma, w1, w2), a and s (M, F) being the
GELU's value and derivative (pallas_mlp.py:317-319, :599-602); the backward
takes the cotangents of both outputs, that of ``y`` (the tap's) entering
the LayerNorm backward, and ``ln_mlp_backward_reference`` is its plain
version.  There is no fallback: a CUDA tensor a kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops._launch import (LaunchCounters, check_tensor,
                                         contiguous_counted, grad_wanted,
                                         raise_on)
from vitta_tpu_torch.ops.cuda_ln import (layer_norm_backward_reference,
                                         layer_norm_reference)

counters = LaunchCounters("fwd", "bwd")

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                     save_residuals: bool = False):
    """The unfused composition on ``x`` (..., C); returns (o, y), and with
    ``save_residuals`` (o, y, a, s)."""
    y = layer_norm_reference(x, gamma, beta, eps)
    h = F.linear(y, w1, b1)
    a = F.gelu(h)
    o = F.linear(a, w2, b2)
    if not save_residuals:
        return o, y
    phi = 0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
    s = phi + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI
    return o, y, a, s


def ln_mlp_backward_reference(x, y, a, s, go, gy, gamma, w1, w2,
                              eps: float = 1e-5):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) for the cotangents ``go`` of
    o and ``gy`` of y (or None), written out from what the forward keeps
    as the kernel computes it (pallas_mlp.py:322-369); all of (M, C) or
    (M, F)."""
    dh = (go @ w2) * s
    dy = dh @ w1
    if gy is not None:
        dy = dy + gy
    dx, dgamma, dbeta = layer_norm_backward_reference(x, gamma, dy, eps)
    return (dx, dgamma, dbeta, dh.t() @ y, dh.sum(dim=0), go.t() @ a,
            go.sum(dim=0))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("mlp")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vitta_lnmlp_fwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                        i, ctypes.c_float, p]
        lib.vitta_lnmlp_fwd.restype = i
        lib.vitta_lnmlp_bwd.argtypes = [p] * 16 + [i, i, i, ctypes.c_float, p]
        lib.vitta_lnmlp_bwd.restype = i
        lib.vitta_lnmlp_bwd_scratch_floats.argtypes = [i, i, i]
        lib.vitta_lnmlp_bwd_scratch_floats.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _check(x2, w1, named):
    """Raise on anything the kernels do not take; ``named`` lists
    (name, tensor, shape as a string of m, c, f).  Returns (M, C, F)."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (M, C), got shape {tuple(x2.shape)}")
    m, c = x2.shape
    f = w1.shape[0]
    dims = {"m": m, "c": c, "f": f}
    for name, ten, shape in named:
        check_tensor("LayerNorm-MLP", name, ten,
                     tuple(dims[d] for d in shape), x2.device)
    if c % 4 != 0 or f % 4 != 0:
        raise ValueError(f"the LayerNorm-MLP kernels take C and F that are "
                         f"multiples of 4 (16-byte rows); got C={c}, F={f}")
    if m == 0:
        raise ValueError("x has no rows")
    return m, c, f


def ln_mlp_fwd_cuda(x2, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                    save_residuals: bool = False):
    """Forward kernels on ``x2`` (M, C): one wrapper call, three launches
    on the current stream; outputs and the (M, F) scratch allocated here."""
    m, c, f = _check(x2, w1, (("x", x2, "mc"), ("gamma", gamma, "c"),
                              ("beta", beta, "c"), ("w1", w1, "fc"),
                              ("b1", b1, "f"), ("w2", w2, "cf"),
                              ("b2", b2, "c")))
    dev = x2.device
    y = torch.empty_like(x2)
    o = torch.empty_like(x2)
    a = torch.empty((m, f), dtype=torch.float32, device=dev)
    s = torch.empty_like(a) if save_residuals else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = _lib().vitta_lnmlp_fwd(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            a.data_ptr(), None if s is None else s.data_ptr(), o.data_ptr(),
            m, c, f, float(eps), stream)
    raise_on(code, "LayerNorm-MLP forward kernel")
    counters.fwd += 1
    return (o, y, a, s) if save_residuals else (o, y)


def ln_mlp_bwd_cuda(x2, y, a, s, go, gy, gamma, w1, w2, eps: float = 1e-5):
    """Backward kernels: one wrapper call, its launches on the current
    stream; ``gy`` may be None (no cotangent on y).  Returns (dx, dgamma,
    dbeta, dw1, db1, dw2, db2), allocated here with the scratch (dh (M, F),
    dy (M, C) and the partial sums)."""
    named = [("x", x2, "mc"), ("y", y, "mc"), ("a", a, "mf"), ("s", s, "mf"),
             ("grad of o", go, "mc"), ("gamma", gamma, "c"),
             ("w1", w1, "fc"), ("w2", w2, "cf")]
    if gy is not None:
        named.append(("grad of y", gy, "mc"))
    m, c, f = _check(x2, w1, named)
    dev = x2.device
    lib = _lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx, dgb, dw1, db1, dw2, db2 = (new(m, c), new(2, c), new(f, c), new(f),
                                   new(c, f), new(c))
    scratch = new(lib.vitta_lnmlp_bwd_scratch_floats(m, c, f))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.vitta_lnmlp_bwd(
            x2.data_ptr(), y.data_ptr(), a.data_ptr(), s.data_ptr(),
            go.data_ptr(), None if gy is None else gy.data_ptr(),
            gamma.data_ptr(), w1.data_ptr(), w2.data_ptr(), dx.data_ptr(),
            dgb.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), scratch.data_ptr(), m, c, f, float(eps), stream)
    raise_on(code, "LayerNorm-MLP backward kernel")
    counters.bwd += 1
    return dx, dgb[0], dgb[1], dw1, db1, dw2, db2


class LayerNormMlp(torch.autograd.Function):
    """The kernels as one differentiable op (the counterpart of the custom
    VJP at pallas_mlp.py:592-615).  With ``keep`` the forward has the
    kernel emit a and s and keeps (x, y, a, s, gamma, w1, w2); without it
    nothing is kept.  An output without a cotangent arrives as None, not
    as zeros; a strided cotangent is copied once, and counted."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, eps, save_residuals,
                keep):
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        res = ln_mlp_fwd_cuda(x2, gamma, beta, w1, b1, w2, b2, eps,
                              save_residuals or keep)
        if keep:
            ctx.save_for_backward(x2, *res[1:], gamma, w1, w2)   # y, a, s
        if not save_residuals:
            return res[:2]
        ctx.mark_non_differentiable(res[2], res[3])
        return res

    @staticmethod
    def backward(ctx, go, gy, *_residual_grads):
        x2, y, a, s, gamma, w1, w2 = ctx.saved_tensors
        go = torch.zeros_like(x2) if go is None else contiguous_counted(go)
        if gy is not None:
            gy = contiguous_counted(gy)
        grads = ln_mlp_bwd_cuda(x2, y, a, s, go, gy, gamma, w1, w2, ctx.eps)
        return grads + (None, None, None)


def ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
           save_residuals: bool = False):
    """(LayerNorm -> fc1 -> exact GELU -> fc2)(x) over the last axis of
    ``x`` (..., C); returns (o, y) in x's shape, and with
    ``save_residuals`` also a and s as (M, F).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernels
    (forward, and backward under autograd), which raise on any dtype other
    than float32, a non-contiguous input, or a C or F that is not a
    multiple of 4."""
    if x.device.type == "cpu":
        res = ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps,
                               save_residuals)
        if save_residuals:
            f = w1.shape[0]
            return res[0], res[1], res[2].reshape(-1, f), res[3].reshape(-1, f)
        return res
    if x.device.type != "cuda":
        raise ValueError(f"no LayerNorm-MLP implementation for device "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    res = LayerNormMlp.apply(x.reshape(-1, x.shape[-1]), gamma, beta, w1, b1,
                             w2, b2, float(eps), save_residuals,
                             grad_wanted(x, gamma, beta, w1, b1, w2, b2))
    return (res[0].reshape(x.shape), res[1].reshape(x.shape)) + tuple(res[2:])
