"""Row LayerNorm, forward and backward: CUDA kernels, plain versions,
autograd wrapper.

    y = (x - mu) * rsqrt(E[x^2] - mu^2 + eps) * gamma + beta

over the last axis, with the one-pass float32 statistics of the JAX package
(vitta_tpu/models/layers.py:250-253).  ``layer_norm`` sends a CPU tensor to
the plain PyTorch version (``layer_norm_reference``, under torch's own
autograd) and a CUDA tensor to the hand-written kernels in
``vitta_tpu_torch/csrc/ln.cu``, the counterparts of
vitta_tpu/ops/pallas_ln.py:47 (forward) and :55 (backward: dx, dgamma,
dbeta from ``(x, gamma, dy)``, the row statistics recomputed).
``layer_norm_backward_reference`` is the backward kernel's plain version.
There is no fallback: a CUDA tensor a kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, check_tensor,
                                         contiguous_counted, grad_wanted,
                                         raise_on)

counters = LaunchCounters("fwd", "bwd")


def layer_norm_reference(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (..., C), one-pass variance."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    mean_sq = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    var = mean_sq - torch.square(mean)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


def layer_norm_backward_reference(x, gamma, dy, eps: float = 1e-5):
    """(dx, dgamma, dbeta) of ``layer_norm_reference`` at ``x`` (R, C) for
    the cotangent ``dy``, written out as the kernel computes it
    (vitta_tpu/ops/pallas_ln.py:55-73)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    mean_sq = torch.mean(torch.square(x), dim=-1, keepdim=True)
    rstd = torch.rsqrt(mean_sq - torch.square(mean) + eps)
    xh = (x - mean) * rstd
    wg = dy * gamma
    dx = rstd * (wg - torch.mean(wg, dim=-1, keepdim=True)
                 - xh * torch.mean(wg * xh, dim=-1, keepdim=True))
    return dx, torch.sum(dy * xh, dim=0), torch.sum(dy, dim=0)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("ln")
        p = ctypes.c_void_p
        lib.vitta_ln_fwd.argtypes = [p, p, p, p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_float, p]
        lib.vitta_ln_fwd.restype = ctypes.c_int
        lib.vitta_ln_bwd.argtypes = [p, p, p, p, p, p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_float, p]
        lib.vitta_ln_bwd.restype = ctypes.c_int
        lib.vitta_ln_bwd_scratch_floats.argtypes = [ctypes.c_longlong,
                                                    ctypes.c_int]
        lib.vitta_ln_bwd_scratch_floats.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def ln_fwd_cuda(x2, gamma, beta, eps: float = 1e-5):
    """Forward kernel on ``x2`` (R, C): one launch, output allocated here."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x2.shape)}")
    rows, c = x2.shape
    check_tensor("LayerNorm", "x", x2, (rows, c), x2.device)
    check_tensor("LayerNorm", "gamma", gamma, (c,), x2.device)
    check_tensor("LayerNorm", "beta", beta, (c,), x2.device)
    y = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        code = _lib().vitta_ln_fwd(x2.data_ptr(), gamma.data_ptr(),
                                   beta.data_ptr(), y.data_ptr(), rows, c,
                                   float(eps), stream)
    raise_on(code, "LayerNorm forward kernel")
    counters.fwd += 1
    return y


def ln_bwd_cuda(x2, gamma, dy, eps: float = 1e-5):
    """Backward kernels on ``x2`` (R, C) and the cotangent ``dy`` (R, C):
    one wrapper call, three launches on the current stream; returns
    (dx, dgamma, dbeta), allocated here with the scratch."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x2.shape)}")
    rows, c = x2.shape
    if rows == 0:
        raise ValueError("x has no rows")
    check_tensor("LayerNorm", "x", x2, (rows, c), x2.device)
    check_tensor("LayerNorm", "gamma", gamma, (c,), x2.device)
    check_tensor("LayerNorm", "grad", dy, (rows, c), x2.device)
    lib = _lib()
    dx = torch.empty_like(x2)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    scratch = torch.empty(lib.vitta_ln_bwd_scratch_floats(rows, c),
                          dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        code = lib.vitta_ln_bwd(x2.data_ptr(), gamma.data_ptr(),
                                dy.data_ptr(), dx.data_ptr(), dgb.data_ptr(),
                                scratch.data_ptr(), rows, c, float(eps),
                                stream)
    raise_on(code, "LayerNorm backward kernel")
    counters.bwd += 1
    return dx, dgb[0], dgb[1]


class LayerNormRows(torch.autograd.Function):
    """The kernel pair as one differentiable op (the counterpart of the
    custom VJP at vitta_tpu/ops/pallas_ln.py:115-131): the forward keeps
    (x, gamma) when a gradient is wanted, the backward recomputes the row
    statistics.  A strided cotangent is copied once, and counted."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, keep):
        ctx.eps = eps
        if keep:
            ctx.save_for_backward(x2, gamma)
        return ln_fwd_cuda(x2, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x2, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = ln_bwd_cuda(x2, gamma, contiguous_counted(g),
                                        ctx.eps)
        return dx, dgamma, dbeta, None, None


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (..., C) -> the same shape.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernels
    (forward, and backward under autograd), which raise on any dtype other
    than float32 or a non-contiguous input."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no LayerNorm implementation for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c = x.shape[-1]
    y = LayerNormRows.apply(x.reshape(-1, c), gamma, beta, float(eps),
                            grad_wanted(x, gamma, beta))
    return y.reshape(x.shape)
