"""Row LayerNorm forward: CUDA kernel, plain version, autograd wrapper.

    y = (x - mu) * rsqrt(E[x^2] - mu^2 + eps) * gamma + beta

over the last axis, with the one-pass float32 statistics of the JAX package
(vitta_tpu/models/layers.py:250-253).  ``layer_norm`` sends a CPU tensor to
the plain PyTorch version (``layer_norm_reference``) and a CUDA tensor to
the hand-written kernel in ``vitta_tpu_torch/csrc/ln.cu``, the counterpart
of vitta_tpu/ops/pallas_ln.py:47.  There is no fallback: a CUDA tensor the
kernel does not take raises, and so does a backward pass on the card,
whose kernel (pallas_ln.py:55) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, backward_not_ported,
                                         check_tensor, raise_on)

counters = LaunchCounters("fwd")


def layer_norm_reference(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (..., C), one-pass variance."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    mean_sq = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    var = mean_sq - torch.square(mean)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


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


class LayerNormRows(torch.autograd.Function):
    """The forward kernel as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        return ln_fwd_cuda(x2, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        backward_not_ported("LayerNorm", 4)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of ``x`` (..., C) -> the same shape.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on any dtype other than float32 or a non-contiguous
    input."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no LayerNorm implementation for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c = x.shape[-1]
    y = LayerNormRows.apply(x.reshape(-1, c), gamma, beta, float(eps))
    return y.reshape(x.shape)
