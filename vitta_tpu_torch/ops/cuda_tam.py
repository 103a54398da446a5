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

x (and the cotangent) may be float32 or bfloat16; attn and the weights are
float32.  At bfloat16 the kernels and the plain versions round at the same
points, those of the JAX reference at that type (pallas_tam.py:53,58):
attn and the weights are rounded to bfloat16 as they are read, the
arithmetic is float32, out and dx are rounded to bfloat16 once; dattn and
dkernel stay float32.  Products of bfloat16 values are exact in float32 and
the plain versions add in the kernels' order, so out and dx have the
kernels' bits; dattn and dkernel differ by the order of float32 sums.  On
the CPU ``TamPlain`` runs the plain forward and the plain backward
(``tam_dynamic_conv_backward_reference``) at either dtype: at bfloat16
torch's autograd of the plain forward would round the gradients of attn
and the weights to bfloat16.  At bfloat16 the forward and the backward take
8 channels a thread with 16-byte loads where C % 8 == 0 and their tensors
are 16-byte aligned (every TANet site), one channel a thread elsewhere.
The bfloat16 backward in 16-byte units is one launch: its blocks' partial
rows are added by the blocks that draw the last tickets (csrc/tam.cu:
tam_bwd_bf16x8_kernel; the tickets' slot is the stream's,
``TicketSlots``), and ``bwd_plan_bf16`` mirrors how it cuts the work.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops._launch import (LaunchCounters, TicketSlots,
                                         check_tensor, raise_on,
                                         vector_units)

KSIZE = 3  # reference TAM kernel size (temporal_module.py:27)
# the activations' types the kernels take (attn and the weights: float32)
ACT_DTYPES = (torch.float32, torch.bfloat16)


# launches of the TAM kernels, and contiguity copies of incoming gradients
counters = LaunchCounters("fwd", "bwd", "grad_copies")

# csrc/tam.cu's constants: frames a thread loads together (kDepth), most
# units of a position a block spans, positions a block sums, most frames a
# segment, blocks the grid aims at, threads a block
BWD_DEPTH, BWD_MAX_UNITS, BWD_MIN_POSITIONS = 4, 16, 32
BWD_MAX_SEG_FRAMES, BWD_TARGET_BLOCKS, BWD_THREADS = 16, 132, 256
PLAN_KEYS = ("vec", "units", "wc", "slots", "pp", "seg_len", "nseg", "npb",
             "ncc")
# csrc/tam.cu's constants of the bfloat16 backward in 16-byte units: a
# block's threads, blocks an SM the grid aims at, frames of a segment, most
# units of 8 channels a block spans, runs of slots a block adds at once
B16_THREADS, B16_BLOCKS_PER_SM, B16_FRAMES, B16_MAX_UNITS = 256, 2, 4, 4
B16_SLOT_PARTS = 8
B16_PLAN_KEYS = ("units", "wc", "slots", "pp", "nseg", "npb", "ncc",
                 "blocks")


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


def bwd_plan_bf16(n, t, p, c, sms):
    """How the bfloat16 backward in 16-byte units cuts (N, T, P, C), as
    ``plan_bf16`` in csrc/tam.cu: units of 8 channels; blocks of ``wc``
    units x ``slots`` positions (256 threads or just under), each thread
    walking ``pp`` positions in turn; T in ``nseg`` segments of 4 frames,
    ``ncc`` channel chunks and ``npb`` position blocks, ``blocks`` in all,
    at most two an SM of ``sms`` where the positions allow (pp as small as
    that leaves).  Block b is (n, chunk, position block, segment), the
    segment varying fastest."""
    if c % 8:
        raise ValueError(f"the bfloat16 TAM backward in 16-byte units takes "
                         f"C a multiple of 8, got {c}")
    cdiv = lambda a, b: -(-a // b)
    units = c // 8
    wc = min(units, B16_MAX_UNITS)
    slots = B16_THREADS // wc
    ncc, nseg = cdiv(units, wc), cdiv(t, B16_FRAMES)
    per = n * ncc * nseg
    most = max(B16_BLOCKS_PER_SM * sms // per, 1)
    pp = cdiv(p, most * slots)
    npb = cdiv(p, slots * pp)
    return dict(zip(B16_PLAN_KEYS, (units, wc, slots, pp, nseg, npb, ncc,
                                    per * npb)))


def _rounded(v, dtype):
    """``v`` rounded to ``dtype`` and back: the identity where it is
    ``dtype`` already."""
    return v.to(dtype).to(v.dtype)


def tam_dynamic_conv_reference(x, attn, kernel):
    """x (N,T,H,W,C), attn (N,T,C), kernel (N,C,K) -> (N,T,H,W,C), in the
    kernels' arithmetic: float32, from attn and the weights rounded to x's
    dtype, the output rounded to x's dtype once (at float32 every cast is
    the identity)."""
    t = x.shape[1]
    y = x.float() * _rounded(attn, x.dtype)[:, :, None, None, :]
    pad = KSIZE // 2
    yp = F.pad(y, (0, 0, 0, 0, 0, 0, pad, pad))
    out = torch.zeros_like(y)
    for k in range(KSIZE):
        wk = _rounded(kernel, x.dtype)[:, None, None, None, :, k]
        out = out + wk * yp[:, k:k + t]
    return out.to(x.dtype)


def tam_dynamic_conv_backward_reference(g, x, attn, kernel):
    """(dx, dattn, dkernel) for the cotangent ``g`` of
    ``tam_dynamic_conv_reference``, written out as the backward kernel
    computes it: dy[s] = (K0 g[s+1] + K1 g[s]) + K2 g[s-1] in float32 from
    the rounded weights, dx = attn * dy rounded to x's dtype once, dattn and
    dkernel float32 sums over (H, W) and (T, H, W); the gradients of attn
    and the weights are those of their rounded values."""
    t = x.shape[1]
    a = _rounded(attn, x.dtype)[:, :, None, None, :]
    k = [_rounded(kernel, x.dtype)[:, None, None, None, :, j]
         for j in range(KSIZE)]
    gp = F.pad(g.float(), (0, 0, 0, 0, 0, 0, 1, 1))   # g[-1] = g[T] = 0
    dy = k[0] * gp[:, 2:] + k[1] * gp[:, 1:t + 1] + k[2] * gp[:, :t]
    xf = x.float()
    y = a * xf
    dx = (a * dy).to(x.dtype)
    dattn = torch.sum(dy * xf, dim=(2, 3))
    dkernel = torch.stack([torch.sum(gp[:, 2 - j:2 - j + t] * y,
                                     dim=(1, 2, 3)) for j in range(KSIZE)],
                          dim=-1)
    return dx, dattn, dkernel


class TamPlain(torch.autograd.Function):
    """The plain forward and backward as one differentiable op: the CPU's
    TAM."""

    @staticmethod
    def forward(ctx, x, attn, kernel):
        ctx.save_for_backward(x, attn, kernel)
        return tam_dynamic_conv_reference(x, attn, kernel)

    @staticmethod
    def backward(ctx, g):
        return tam_dynamic_conv_backward_reference(g, *ctx.saved_tensors)


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
        lib.vitta_tam_fwd_bf16.argtypes = [p, p, p, p] + [i] * 5 + [p]
        lib.vitta_tam_fwd_bf16.restype = i
        lib.vitta_tam_bwd_bf16.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.vitta_tam_bwd_bf16.restype = i
        lib.vitta_tam_bwd_bf16_scratch_floats.argtypes = [i] * 5
        lib.vitta_tam_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_tam_bwd_bf16_plan.argtypes = [i] * 4 + [p]
        lib.vitta_tam_bwd_bf16_plan.restype = None
        lib.vitta_tam_slots.argtypes = []
        lib.vitta_tam_slots.restype = i
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
    check_tensor("TAM", "x", x, x.shape, x.device, dtypes=ACT_DTYPES)
    check_tensor("TAM", "attn", attn, (n, t, c), x.device)
    check_tensor("TAM", "kernel", kernel, (n, c, KSIZE), x.device)
    if g is not None:
        check_tensor("TAM", "grad", g, x.shape, x.device, dtypes=(x.dtype,))
    return n, t, h * w, c


def bwd_vec(c, *tensors) -> int:
    """1 where the backward takes 16-byte units (4 channels of float32, 8
    of bfloat16; attn float32 either way), else 0 (one channel a
    thread)."""
    bf16 = any(t.dtype == torch.bfloat16 for t in tensors)
    return vector_units(c, 8 if bf16 else 4, *tensors)


# the slot of the bfloat16 backward's tickets each (device, stream) uses
ticket_slot = TicketSlots("bfloat16 TAM backward")


def fwd_vec_bf16(c, *tensors) -> int:
    """1 where the bfloat16 forward takes 8 channels a thread (16 bytes of
    x and out, 32 of attn, each 16-byte aligned), else 0."""
    return vector_units(c, 8, *tensors)


def bwd_plan_cuda(n, t, p, c, vec=None):
    """The backward kernel's own plan for (N, T, P, C), from csrc/tam.cu."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    vec = int(c % 4 == 0 if vec is None else vec)
    _lib().vitta_tam_bwd_plan(n, t, p, c, vec, out)
    return dict(zip(PLAN_KEYS, out))


def bwd_plan_bf16_cuda(n, t, p, c):
    """The bfloat16 backward's own plan in 16-byte units, from csrc/tam.cu,
    with the card's SMs it was made for (``sms``)."""
    keys = B16_PLAN_KEYS + ("sms",)
    out = (ctypes.c_longlong * len(keys))()
    _lib().vitta_tam_bwd_bf16_plan(n, t, p, c, out)
    return dict(zip(keys, out))


def tam_fwd_cuda(x, attn, kernel):
    """Forward kernel: one launch, output allocated here."""
    n, t, p, c = _check(x, attn, kernel)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), attn.data_ptr(), kernel.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        if x.dtype == torch.float32:
            code = _lib().vitta_tam_fwd(*ptrs, n, t, p, c, stream)
        else:
            code = _lib().vitta_tam_fwd_bf16(
                *ptrs, n, t, p, c, fwd_vec_bf16(c, x, attn, out), stream)
    raise_on(code, "TAM forward kernel")
    counters.fwd += 1
    return out


def tam_bwd_cuda(g, x, attn, kernel):
    """Backward kernel: (dx, dattn, dkernel) for the cotangent ``g``.  At
    bfloat16 in 16-byte units (``bwd_vec`` 1) one launch, which also adds
    the blocks' partial rows, with the stream's slot of tickets; otherwise
    two launches, the second the sum of the blocks' partial rows."""
    n, t, p, c = _check(x, attn, kernel, g)
    lib = _lib()
    dx = torch.empty_like(x)
    dattn = torch.empty_like(attn)
    dkernel = torch.empty_like(kernel)
    vec = bwd_vec(c, g, x, attn, dx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (g.data_ptr(), x.data_ptr(), attn.data_ptr(), kernel.data_ptr(),
            dx.data_ptr())
    outs = (dattn.data_ptr(), dkernel.data_ptr())
    if x.dtype == torch.float32:
        scratch = torch.empty(lib.vitta_tam_bwd_scratch_floats(n, t, p, c,
                                                               vec),
                              dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            code = lib.vitta_tam_bwd(*ptrs, scratch.data_ptr(), *outs, n, t,
                                     p, c, vec, stream)
    else:
        slot = ticket_slot(x.device, stream, lib.vitta_tam_slots()) \
            if vec else 0
        scratch = torch.empty(
            lib.vitta_tam_bwd_bf16_scratch_floats(n, t, p, c, vec),
            dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            code = lib.vitta_tam_bwd_bf16(*ptrs, scratch.data_ptr(), *outs,
                                          n, t, p, c, vec, slot, stream)
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

    x is float32 or bfloat16 (and so is out), attn and kernel float32.  A
    CPU tensor takes the plain versions (``TamPlain``); a CUDA tensor takes
    the kernels, which raise on any other dtype, any other shape, or a
    non-contiguous input."""
    if x.device.type == "cpu":
        return TamPlain.apply(x, attn, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"no TAM implementation for device {x.device}")
    return TamDynamicConv.apply(x, attn, kernel)
