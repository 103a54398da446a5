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
not take raises.  ``bwd_plan`` mirrors how the backward kernel cuts its
work (``plan_for`` in tam.cu), so that the CPU tests can follow its order
of summation.  The backward takes 4 channels a thread with 16-byte loads
only where C % 4 == 0 and its inputs are 16-byte aligned; a view that
starts elsewhere takes its one-channel path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops._launch import (LaunchCounters, check_tensor,
                                         float4_units, raise_on)

KSIZE = 3  # reference TAM kernel size (temporal_module.py:27)


# launches of the TAM kernels, and contiguity copies of incoming gradients
counters = LaunchCounters("fwd", "bwd", "grad_copies")

# csrc/tam.cu's constants: frames a thread loads together (kDepth), most
# units of a position a block spans, positions a block sums, most frames a
# segment, blocks the grid aims at, threads a block
BWD_DEPTH, BWD_MAX_UNITS, BWD_MIN_POSITIONS = 4, 16, 32
BWD_MAX_SEG_FRAMES, BWD_TARGET_BLOCKS, BWD_THREADS = 16, 132, 256
PLAN_KEYS = ("vec", "units", "wc", "slots", "pp", "seg_len", "nseg", "npb",
             "ncc")


def bwd_plan(n, t, p, c, vec=None, depth=BWD_DEPTH):
    """How the backward kernel cuts (N, T, P, C), as ``plan_for`` in
    csrc/tam.cu: units of 4 channels where ``vec`` (by default C % 4 == 0;
    the kernel also needs its inputs 16-byte aligned), else of 1; a block
    of ``wc`` units x ``slots`` positions, each thread walking ``pp``
    positions; ``npb`` position blocks, ``ncc`` channel chunks; T cut into
    ``nseg`` segments of ``seg_len`` frames."""
    cdiv = lambda a, b: -(-a // b)
    vec = int(c % 4 == 0 if vec is None else vec)
    units = c // 4 if vec else c
    wc = min(units, BWD_MAX_UNITS)
    slots = BWD_THREADS // wc
    pp = cdiv(BWD_MIN_POSITIONS, slots)
    npb = cdiv(p, slots * pp)
    ncc = cdiv(units, wc)
    blocks = n * ncc * npb
    want = 1 if blocks >= BWD_TARGET_BLOCKS else cdiv(BWD_TARGET_BLOCKS,
                                                       blocks)
    chunks = min(max(cdiv(t, depth) // want, 1),
                 max(BWD_MAX_SEG_FRAMES // depth, 1))
    seg_len = chunks * depth
    return dict(zip(PLAN_KEYS, (vec, units, wc, slots, pp, seg_len,
                                cdiv(t, seg_len), npb, ncc)))


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
        lib.vitta_tam_bwd.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.vitta_tam_bwd.restype = i
        lib.vitta_tam_bwd_scratch_floats.argtypes = [i] * 5
        lib.vitta_tam_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_tam_bwd_plan.argtypes = [i] * 5 + [p]
        lib.vitta_tam_bwd_plan.restype = None
        _LIB = lib
    return _LIB


def _check(x, attn, kernel, g=None):
    """Raise on anything the kernel does not take; return (N, T, P, C)."""
    if x.dim() != 5:
        raise ValueError(f"x must be (N,T,H,W,C), got shape {tuple(x.shape)}")
    n, t, h, w, c = x.shape
    want = [("x", x, x.shape), ("attn", attn, (n, t, c)),
            ("kernel", kernel, (n, c, KSIZE))]
    if g is not None:
        want.append(("grad", g, x.shape))
    for name, ten, shape in want:
        check_tensor("TAM", name, ten, shape, x.device)
    return n, t, h * w, c


# 1 where the backward takes 16-byte units of 4 channels, else 0 (one
# channel a thread)
bwd_vec = float4_units


def bwd_plan_cuda(n, t, p, c, vec=None):
    """The backward kernel's own plan for (N, T, P, C), from csrc/tam.cu."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    vec = int(c % 4 == 0 if vec is None else vec)
    _lib().vitta_tam_bwd_plan(n, t, p, c, vec, out)
    return dict(zip(PLAN_KEYS, out))


def tam_fwd_cuda(x, attn, kernel):
    """Forward kernel: one launch, output allocated here."""
    n, t, p, c = _check(x, attn, kernel)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib().vitta_tam_fwd(x.data_ptr(), attn.data_ptr(),
                                    kernel.data_ptr(), out.data_ptr(),
                                    n, t, p, c, stream)
    raise_on(code, "TAM forward kernel")
    counters.fwd += 1
    return out


def tam_bwd_cuda(g, x, attn, kernel):
    """Backward kernel: (dx, dattn, dkernel) for the cotangent ``g``; two
    launches, the second the sum of the blocks' partial rows."""
    n, t, p, c = _check(x, attn, kernel, g)
    lib = _lib()
    dx = torch.empty_like(x)
    dattn = torch.empty_like(attn)
    dkernel = torch.empty_like(kernel)
    vec = bwd_vec(c, g, x, attn, dx)
    scratch = torch.empty(lib.vitta_tam_bwd_scratch_floats(n, t, p, c, vec),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.vitta_tam_bwd(g.data_ptr(), x.data_ptr(), attn.data_ptr(),
                                 kernel.data_ptr(), dx.data_ptr(),
                                 scratch.data_ptr(), dattn.data_ptr(),
                                 dkernel.data_ptr(), n, t, p, c, vec,
                                 stream)
    raise_on(code, "TAM backward kernel")
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
