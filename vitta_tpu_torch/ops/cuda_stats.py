"""BatchNorm (inference form) + optional ReLU + channel statistics of the
output: CUDA kernels, plain versions, autograd wrapper.

    y = (x - mean) * rsqrt(var + eps) * scale + bias,  y = max(y, 0) if relu
    m = sum_rows(y) / R,  v = sum_rows(y^2) / R - m^2

over the rows of a channels-last ``x`` (..., C) with per-channel ``scale``,
``bias``, ``mean``, ``var`` (C,): what ``BatchNorm`` in its inference form
followed by ``channel_stats`` of its output computes, with one read of ``x``
and one write of ``y``.  ``fused_bn_relu_stats`` keeps the contract of
vitta_tpu/ops/pallas_stats.py:68 (``relu`` is an argument, the statistics are
of the tensor it returns) and sends a CPU tensor to the plain PyTorch versions
(``fused_bn_relu_stats_reference`` and its backward) and a CUDA tensor to
the hand-written kernels in ``vitta_tpu_torch/csrc/bn_stats.cu``.
The JAX function has no backward; the port's ``BatchNorm`` calls this op on
the adaptation path, so here it has one (``fused_bn_relu_stats_backward_
reference`` is its plain version): ``mean`` and ``var`` are buffers in the
inference form and get no gradient.  There is no fallback: a CUDA tensor the
kernels do not take raises.

x (with y, the cotangent of y and dx) may be float32 or bfloat16; the
parameters, the statistics and their cotangents are float32.  At bfloat16
the arithmetic is float32, y is rounded to bfloat16 once, and m and v are
the statistics of that rounded y: what vitta_tpu/models/layers.py:183-190,
the tapped BatchNorm this op serves, records (``y.astype(float32)``), not
the Pallas kernel's sums of the unrounded y (pallas_stats.py:54-57), which
no vitta_tpu model calls.  The backward keeps G, the cotangent of y plus
those of m and v, in float32 (JAX's autodiff rounds it to bfloat16 there),
uses the rounded y in the v term, and rounds dx to bfloat16 once.  On the
CPU ``BnReluStatsPlain`` runs the plain forward and the plain backward
(``fused_bn_relu_stats_backward_reference``) at either dtype: at bfloat16
torch's autograd of the plain forward would round G as JAX does.

Each kernel is one launch a call: its blocks' column sums go up through
their cluster and a ticket drawn per column tile, and the block that draws
a tile's last ticket adds the tile's partials in a fixed order and resets
the ticket to 0 (csrc/bn_stats.cu).  ``bn_plan`` mirrors how the kernels
cut (R, C), so that the CPU tests can follow their order of summation.
"""

from __future__ import annotations

import ctypes

import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, TicketSlots,
                                         check_tensor, grad_wanted, raise_on)
from vitta_tpu_torch.ops.stats import TapStats, channel_stats

counters = LaunchCounters("fwd", "bwd")

# the types the kernels take for x, y, the cotangent of y and dx
ACT_DTYPES = (torch.float32, torch.bfloat16)

# csrc/bn_stats.cu's plan: threads along C, warps (row groups) a block,
# fewest rows a block, most blocks of a cluster, most blocks an SM
LANES, WARPS, MIN_CHUNK, MAX_CLUSTER, BLOCKS_PER_SM = 32, 8, 32, 8, 2
PLAN_KEYS = ("tiles", "csize", "chunk", "chunks")


def bn_plan(rows: int, c: int, v: int, resident: int, sms: int) -> dict:
    """How the kernels cut (rows, C) at ``v`` columns a thread (8 at
    bfloat16 or 4 at float32 where C and the pointers allow 16-byte units,
    else 1), as ``bn_plan`` in csrc/bn_stats.cu: a grid of ``chunks`` x
    ``tiles`` blocks of 32 x 8 threads, block (i, j) taking rows [i chunk,
    (i + 1) chunk) of columns [32 v j, 32 v (j + 1)), clusters of ``csize``
    blocks along the rows.  All blocks fit in one wave, shared evenly by
    the tiles: at most ``resident`` clusters of 8 (what the card holds of
    the kernel at once) and two blocks an SM of ``sms``.  The cluster is
    the largest whose multiples leave at most an eighth of a tile's share
    unused, and no larger than the rows allow; each block takes at least
    32 rows."""
    cdiv = lambda a, b: -(-a // b)
    tiles = cdiv(c, LANES * v)
    wave = min(resident * MAX_CLUSTER, BLOCKS_PER_SM * sms)
    share = max(wave // tiles, 1)
    csize = MAX_CLUSTER
    while csize > 1 and share // csize * csize * 8 < 7 * share:
        csize //= 2
    chunk = max(cdiv(cdiv(rows, share // csize * csize), WARPS) * WARPS,
                MIN_CHUNK)
    n = cdiv(rows, chunk)
    while csize > n:
        csize //= 2
    return dict(zip(PLAN_KEYS, (tiles, csize, chunk, cdiv(n, csize) * csize)))


def fused_bn_relu_stats_reference(x, scale, bias, mean, var, *,
                                  eps: float = 1e-5, relu: bool = True):
    """``(y, TapStats(m, v))`` of ``x`` (..., C) in plain PyTorch: the
    normalization as one float32 ``addcmul`` pass (x bfloat16 is read as
    float32 without a copy), y rounded to x's dtype, then ``channel_stats``
    of that (post-ReLU) y."""
    inv = torch.rsqrt(var + eps) * scale
    y = torch.addcmul(bias - mean * inv, x, inv)
    if relu:
        y = torch.relu(y)
    y = y.to(x.dtype)
    return y, channel_stats(y)


def fused_bn_relu_stats_backward_reference(x, scale, bias, mean, var, m,
                                           g_y=None, g_m=None, g_v=None, *,
                                           eps: float = 1e-5,
                                           relu: bool = True):
    """(dx, dscale, dbias) at ``x`` (R, C) for the cotangents of y, m and v
    (None: zero), written out as the backward kernel computes it: y is
    recomputed from ``x`` and rounded to its dtype, ``m`` is the forward's
    mean, G is float32 and dx is rounded to x's dtype once."""
    rows = x.shape[0]
    xf = x.float()
    rstd = torch.rsqrt(var + eps)
    inv = rstd * scale
    xhat = (xf - mean) * rstd
    t = torch.addcmul(bias - mean * inv, xf, inv)
    y = (torch.relu(t) if relu else t).to(x.dtype).float()
    g = torch.zeros_like(xf) if g_y is None else g_y.float()
    if g_m is not None:
        g = g + g_m / rows
    if g_v is not None:
        g = g + g_v * 2.0 * (y - m) / rows
    if relu:
        g = g * (t > 0)
    return ((g * inv).to(x.dtype), torch.sum(g * xhat, dim=0),
            torch.sum(g, dim=0))


_LIB = None


def bind(lib):
    """Declare the C interface of a build of csrc/bn_stats.cu on ``lib``."""
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.vitta_bn_stats_scratch_floats.argtypes = [ll, i, i]
    lib.vitta_bn_stats_scratch_floats.restype = ll
    lib.vitta_bn_stats_plan.argtypes = [ll, i, i, i, i, p]
    lib.vitta_bn_stats_plan.restype = None
    lib.vitta_bn_stats_slots.argtypes = []
    lib.vitta_bn_stats_slots.restype = i
    for name, ptrs in (("fwd", 8), ("bwd", 12)):
        for entry in (f"vitta_bn_stats_{name}", f"vitta_bn_stats_{name}_bf16"):
            getattr(lib, entry).argtypes = [p] * ptrs + [ll, i, f, i, i, p]
            getattr(lib, entry).restype = i
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        _LIB = bind(load_library("bn_stats"))
    return _LIB


def bn_plan_cuda(rows: int, c: int, v: int, dtype, bwd: bool) -> dict:
    """The plan of the kernel instance at (rows, C), ``v`` columns a thread,
    x of ``dtype``, forward or backward, from csrc/bn_stats.cu, with what
    it was made for: the clusters of the kernel the card holds at once
    (``resident``) and the card's SMs (``sms``)."""
    out = (ctypes.c_longlong * (len(PLAN_KEYS) + 2))()
    _lib().vitta_bn_stats_plan(rows, c, v, int(dtype == torch.bfloat16),
                               int(bwd), out)
    return dict(zip(PLAN_KEYS + ("resident", "sms"), out))


ticket_slot = TicketSlots("BatchNorm-statistics")


def _launch_args(x2):
    """(library, slot, stream) of a call on ``x2``'s device and the current
    stream."""
    lib = _lib()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    return lib, ticket_slot(x2.device, stream, lib.vitta_bn_stats_slots()), \
        stream


def _check_inputs(x2, scale, bias, mean, var):
    if x2.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x2.shape)}")
    rows, c = x2.shape
    if rows == 0 or c == 0:
        raise ValueError(f"x has shape {tuple(x2.shape)}: nothing to reduce")
    check_tensor("BatchNorm-statistics", "x", x2, (rows, c), x2.device,
                 dtypes=ACT_DTYPES)
    for name, ten in (("scale", scale), ("bias", bias), ("mean", mean),
                      ("var", var)):
        check_tensor("BatchNorm-statistics", name, ten, (c,), x2.device)
    return rows, c


def bn_stats_fwd_cuda(x2, scale, bias, mean, var, eps: float = 1e-5,
                      relu: bool = True):
    """Forward kernel on ``x2`` (R, C): one launch on the current stream,
    which also adds its partials up; returns (y, m, v), allocated here with
    the partials' scratch.  The tickets' slot is the stream's
    (``TicketSlots``)."""
    rows, c = _check_inputs(x2, scale, bias, mean, var)
    lib, slot, stream = _launch_args(x2)
    y = torch.empty_like(x2)
    stats = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    scratch = torch.empty(
        lib.vitta_bn_stats_scratch_floats(rows, c,
                                          int(x2.dtype == torch.bfloat16)),
        dtype=torch.float32, device=x2.device)
    entry = (lib.vitta_bn_stats_fwd if x2.dtype == torch.float32
             else lib.vitta_bn_stats_fwd_bf16)
    with torch.cuda.device(x2.device):
        code = entry(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            var.data_ptr(), y.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), rows, c, float(eps), int(relu), slot, stream)
    raise_on(code, "BatchNorm-statistics forward kernel")
    counters.fwd += 1
    return y, stats[0], stats[1]


def bn_stats_bwd_cuda(x2, scale, bias, mean, var, m, g_y=None, g_m=None,
                      g_v=None, eps: float = 1e-5, relu: bool = True):
    """Backward kernel on ``x2`` (R, C), the forward's mean ``m`` (C,) and
    the cotangents ``g_y`` (R, C), ``g_m`` (C,), ``g_v`` (C,), each of which
    may be None: one launch; returns (dx, dscale, dbias).  A strided
    ``g_y`` raises and is never copied; the (C,) cotangents are laid out
    contiguously where they are not (the gradient of a sum over channels is
    one expanded scalar)."""
    rows, c = _check_inputs(x2, scale, bias, mean, var)
    check_tensor("BatchNorm-statistics", "m", m, (c,), x2.device)
    g_m = None if g_m is None else g_m.contiguous()
    g_v = None if g_v is None else g_v.contiguous()
    for name, ten, shape, dtype in (
            ("the cotangent of y", g_y, (rows, c), x2.dtype),
            ("the cotangent of the mean", g_m, (c,), torch.float32),
            ("the cotangent of the variance", g_v, (c,), torch.float32)):
        if ten is not None:
            check_tensor("BatchNorm-statistics", name, ten, shape, x2.device,
                         dtypes=(dtype,))
    lib, slot, stream = _launch_args(x2)
    dx = torch.empty_like(x2)
    dsb = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    scratch = torch.empty(
        lib.vitta_bn_stats_scratch_floats(rows, c,
                                          int(x2.dtype == torch.bfloat16)),
        dtype=torch.float32, device=x2.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    entry = (lib.vitta_bn_stats_bwd if x2.dtype == torch.float32
             else lib.vitta_bn_stats_bwd_bf16)
    with torch.cuda.device(x2.device):
        code = entry(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            var.data_ptr(), m.data_ptr(), ptr(g_y), ptr(g_m), ptr(g_v),
            dx.data_ptr(), dsb.data_ptr(), scratch.data_ptr(), rows, c,
            float(eps), int(relu), slot, stream)
    raise_on(code, "BatchNorm-statistics backward kernel")
    counters.bwd += 1
    return dx, dsb[0], dsb[1]


class BnReluStats(torch.autograd.Function):
    """The kernel pair as one differentiable op over (y, m, v).  The forward
    keeps x, the parameters and m when a gradient is wanted, not y: the
    backward recomputes y from x (recovering xhat from y would divide by
    ``scale``).  Absent cotangents stay absent (no zeros are made)."""

    @staticmethod
    def forward(ctx, x2, scale, bias, mean, var, eps, relu, keep):
        ctx.eps, ctx.relu = eps, relu
        ctx.set_materialize_grads(False)
        y, m, v = bn_stats_fwd_cuda(x2, scale, bias, mean, var, eps, relu)
        if keep:
            ctx.save_for_backward(x2, scale, bias, mean, var, m)
        return y, m, v

    @staticmethod
    def backward(ctx, g_y, g_m, g_v):
        x2, scale, bias, mean, var, m = ctx.saved_tensors
        dx, dscale, dbias = bn_stats_bwd_cuda(
            x2, scale, bias, mean, var, m, g_y, g_m, g_v, ctx.eps, ctx.relu)
        return dx, dscale, dbias, None, None, None, None, None


class BnReluStatsPlain(torch.autograd.Function):
    """The plain forward and backward as one differentiable op over (y, m,
    v): the CPU's op."""

    @staticmethod
    def forward(ctx, x2, scale, bias, mean, var, eps, relu):
        ctx.eps, ctx.relu = eps, relu
        ctx.set_materialize_grads(False)
        y, (m, v) = fused_bn_relu_stats_reference(x2, scale, bias, mean, var,
                                                  eps=eps, relu=relu)
        ctx.save_for_backward(x2, scale, bias, mean, var, m)
        return y, m, v

    @staticmethod
    def backward(ctx, g_y, g_m, g_v):
        x2, scale, bias, mean, var, m = ctx.saved_tensors
        dx, dscale, dbias = fused_bn_relu_stats_backward_reference(
            x2, scale, bias, mean, var, m, g_y, g_m, g_v, eps=ctx.eps,
            relu=ctx.relu)
        return dx, dscale, dbias, None, None, None, None


def fused_bn_relu_stats(x, scale, bias, mean, var, *, eps: float = 1e-5,
                        relu: bool = True):
    """``(y, TapStats(m, v))``: y in the shape of ``x`` (..., C), the
    statistics (C,) over all leading axes.

    y has x's dtype, float32 or bfloat16; the parameters and statistics are
    float32.  A CPU tensor takes the plain versions (``BnReluStatsPlain``);
    a CUDA tensor takes the kernels (forward, and backward under autograd),
    which raise on any other dtype, on a non-contiguous input or cotangent
    of y (the leading axes are flattened as a view, no activation is
    copied), and on a ``mean`` or ``var`` that asks for a gradient."""
    if x.device.type == "cpu":
        c = x.shape[-1]
        y, m, v = BnReluStatsPlain.apply(x.reshape(-1, c), scale, bias, mean,
                                         var, float(eps), bool(relu))
        return y.reshape(x.shape), TapStats(m, v)
    if x.device.type != "cuda":
        raise ValueError("no BatchNorm-statistics implementation for device "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if grad_wanted(mean, var):
        raise ValueError("mean and var get no gradient from the kernel: they "
                         "are buffers in BatchNorm's inference form")
    c = x.shape[-1]
    y, m, v = BnReluStats.apply(x.reshape(-1, c), scale, bias, mean, var,
                                float(eps), bool(relu),
                                grad_wanted(x, scale, bias))
    return y.reshape(x.shape), TapStats(m, v)
