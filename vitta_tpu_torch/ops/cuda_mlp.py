"""Fused LayerNorm -> MLP forward: CUDA kernel, plain version, wrapper.

    y = LayerNorm(x) * gamma + beta;  o = fc2(gelu(fc1(y)))   (exact GELU)

over the last axis, returning ``(o, y)``: ``y`` is the LayerNorm output
that the norm2 statistic tap reads.  The weights are in ``nn.Linear``
layout, w1 (F, C) and w2 (C, F).  ``ln_mlp`` sends a CPU tensor to the
plain PyTorch version (``ln_mlp_reference``, the counterpart of
vitta_tpu/ops/pallas_mlp.py:618) and a CUDA tensor to the hand-written
kernels in ``vitta_tpu_torch/csrc/mlp.cu``, the counterpart of
pallas_mlp.py:303-319; both matrix products are the kernel's own.  With
``save_residuals`` the GELU value ``a`` and derivative ``s`` (M, F) come
back too, as a backward wants them (pallas_mlp.py:317-319).  There is no
fallback: a CUDA tensor the kernel does not take raises, and so does a
backward pass on the card, whose kernel (pallas_mlp.py:322) is not ported
yet.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops._launch import (LaunchCounters, backward_not_ported,
                                         check_tensor, raise_on)
from vitta_tpu_torch.ops.cuda_ln import layer_norm_reference

counters = LaunchCounters("fwd")

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
        _LIB = lib
    return _LIB


def ln_mlp_fwd_cuda(x2, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                    save_residuals: bool = False):
    """Forward kernels on ``x2`` (M, C): one wrapper call, three launches
    on the current stream; outputs and the (M, F) scratch allocated here."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (M, C), got shape {tuple(x2.shape)}")
    m, c = x2.shape
    f = w1.shape[0]
    dev = x2.device
    for name, ten, shape in (("x", x2, (m, c)), ("gamma", gamma, (c,)),
                             ("beta", beta, (c,)), ("w1", w1, (f, c)),
                             ("b1", b1, (f,)), ("w2", w2, (c, f)),
                             ("b2", b2, (c,))):
        check_tensor("LayerNorm-MLP", name, ten, shape, dev)
    if c % 4 != 0 or f % 4 != 0:
        raise ValueError(f"the LayerNorm-MLP kernel takes C and F that are "
                         f"multiples of 4 (16-byte rows); got C={c}, F={f}")
    if m == 0:
        raise ValueError("x has no rows")
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


class LayerNormMlp(torch.autograd.Function):
    """The forward kernels as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, eps, save_residuals):
        res = ln_mlp_fwd_cuda(x2, gamma, beta, w1, b1, w2, b2, eps,
                              save_residuals)
        if save_residuals:
            ctx.mark_non_differentiable(res[2], res[3])
        return res

    @staticmethod
    def backward(ctx, *grads):
        backward_not_ported("fused LayerNorm-MLP", 11)


def ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
           save_residuals: bool = False):
    """(LayerNorm -> fc1 -> exact GELU -> fc2)(x) over the last axis of
    ``x`` (..., C); returns (o, y) in x's shape, and with
    ``save_residuals`` also a and s as (M, F).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on any dtype other than float32, a non-contiguous input,
    or a C or F that is not a multiple of 4."""
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
                             w2, b2, float(eps), save_residuals)
    return (res[0].reshape(x.shape), res[1].reshape(x.shape)) + tuple(res[2:])
