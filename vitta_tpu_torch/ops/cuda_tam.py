"""TAM dynamic temporal convolution: CUDA kernel, plain version, autograd.

The TAM applies, per (sample, channel), a dynamic depthwise temporal conv
to attention-scaled features (reference
models/tanet_models/temporal_module.py:43-65):

    y[t] = attn[t] * x[t];   out[t] = sum_k K[k] * y[t+k-1]   (K=3, zero pad)

``tam_dynamic_conv`` sends a CPU tensor to the plain PyTorch version
(``tam_dynamic_conv_reference``, the counterpart of
vitta_tpu/ops/pallas_tam.py:50) and a CUDA tensor to the hand-written
kernel in ``vitta_tpu_torch/csrc/tam.cu`` (forward and backward, wrapped in
``TamDynamicConv``).  There is no fallback: a CUDA tensor the kernel does
not take raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

KSIZE = 3  # reference TAM kernel size (temporal_module.py:27)


class LaunchCounters:
    """Launches of the TAM kernels, and contiguity copies of incoming
    gradients, since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.fwd = 0
        self.bwd = 0
        self.grad_copies = 0


counters = LaunchCounters()


def tam_dynamic_conv_reference(x, attn, kernel):
    """x (N,T,H,W,C), attn (N,T,C), kernel (N,C,K) -> (N,T,H,W,C)."""
    t = x.shape[1]
    y = x * attn[:, :, None, None, :].to(x.dtype)
    pad = KSIZE // 2
    yp = F.pad(y, (0, 0, 0, 0, 0, 0, pad, pad))
    out = torch.zeros_like(y)
    for k in range(KSIZE):
        wk = kernel[:, None, None, None, :, k].to(x.dtype)
        out = out + wk * yp[:, k:k + t]
    return out


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("tam")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vitta_tam_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.vitta_tam_fwd.restype = i
        lib.vitta_tam_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.vitta_tam_bwd.restype = i
        lib.vitta_tam_bwd_scratch_floats.argtypes = [i, i, i, i]
        lib.vitta_tam_bwd_scratch_floats.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _check(x, attn, kernel, g=None):
    """Raise on anything the kernel does not take; return (N, T, P, C)."""
    if x.dim() != 5:
        raise ValueError(f"x must be (N,T,H,W,C), got shape {tuple(x.shape)}")
    n, t, h, w, c = x.shape
    want = {"attn": (attn, (n, t, c)), "kernel": (kernel, (n, c, KSIZE))}
    if g is not None:
        want["grad"] = (g, tuple(x.shape))
    for name, (ten, shape) in (("x", (x, tuple(x.shape))), *want.items()):
        if ten.device != x.device or ten.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {ten.device}")
        if ten.dtype != torch.float32:
            raise TypeError(f"the TAM kernel takes float32 only; {name} is "
                            f"{ten.dtype}")
        if tuple(ten.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ten.shape)}, "
                             f"expected {shape}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, t, h * w, c


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def tam_fwd_cuda(x, attn, kernel):
    """Forward kernel: one launch, output allocated here."""
    n, t, p, c = _check(x, attn, kernel)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib().vitta_tam_fwd(x.data_ptr(), attn.data_ptr(),
                                    kernel.data_ptr(), out.data_ptr(),
                                    n, t, p, c, stream)
    _raise_on(code, "TAM forward kernel")
    counters.fwd += 1
    return out


def tam_bwd_cuda(g, x, attn, kernel):
    """Backward kernel: (dx, dattn, dkernel) for the cotangent ``g``."""
    n, t, p, c = _check(x, attn, kernel, g)
    lib = _lib()
    dx = torch.empty_like(x)
    dattn = torch.empty_like(attn)
    dkernel = torch.empty_like(kernel)
    partial = torch.empty(lib.vitta_tam_bwd_scratch_floats(n, t, p, c),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.vitta_tam_bwd(g.data_ptr(), x.data_ptr(), attn.data_ptr(),
                                 kernel.data_ptr(), dx.data_ptr(),
                                 partial.data_ptr(), dattn.data_ptr(),
                                 dkernel.data_ptr(), n, t, p, c, stream)
    _raise_on(code, "TAM backward kernel")
    counters.bwd += 1
    return dx, dattn, dkernel


class TamDynamicConv(torch.autograd.Function):
    """The kernel pair as one differentiable op (the counterpart of the
    custom VJP at vitta_tpu/ops/pallas_tam.py:216-232)."""

    @staticmethod
    def forward(ctx, x, attn, kernel):
        ctx.save_for_backward(x, attn, kernel)
        return tam_fwd_cuda(x, attn, kernel)

    @staticmethod
    def backward(ctx, g):
        x, attn, kernel = ctx.saved_tensors
        if not g.is_contiguous():
            counters.grad_copies += 1
            g = g.contiguous()
        return tam_bwd_cuda(g, x, attn, kernel)


def tam_dynamic_conv(x, attn, kernel):
    """Fused y = dynconv_t(attn * x). x (N,T,H,W,C), attn (N,T,C) in
    [0,1], kernel (N,C,K=3) softmax weights -> (N,T,H,W,C).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on any dtype other than float32, any other shape, or a
    non-contiguous input."""
    if x.device.type == "cpu":
        return tam_dynamic_conv_reference(x, attn, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"no TAM implementation for device {x.device}")
    return TamDynamicConv.apply(x, attn, kernel)
