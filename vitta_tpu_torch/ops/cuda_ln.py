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
``layer_norm_backward_reference`` is the backward kernel's plain version;
``ln_bwd_plan`` mirrors how the backward kernel cuts its rows (its blocks'
column sums are added in the order the plan fixes; the card tests hold it
to the kernel's own).  There is no fallback: a CUDA tensor a kernel does
not take raises.

At bfloat16 (x, y, dy and dx bfloat16; gamma, beta, the statistics, every
sum, dgamma and dbeta float32) the kernels round y and dx once, where
vitta_tpu/ops/pallas_ln.py:47-73 rounds them at the compute dtype, and the
plain versions round at the same points.  The bfloat16 forward takes
16-byte units of 8 values where ``fwd_vec_bf16`` says so (C % 8 == 0, C <=
2048, every tensor 16-byte aligned: every Video Swin width);
``ln_fwd_bf16_plan`` mirrors how that kernel cuts its rows and in what
order it adds a row (csrc/ln_rows.cuh: ln_fwd_bf16x8), one value at a time
elsewhere.  The bfloat16 backward takes
16-byte units of 8 values in one launch where ``bwd_vec_bf16`` says so
(C % 8 == 0, C <= 2048, every tensor 16-byte aligned: every Video Swin
site); ``ln_bwd_bf16_plan`` mirrors how that kernel cuts its rows and where
it adds its sums (csrc/ln.cu: ln_bwd_bf16x8), and its tickets' slot is the
stream's (``TicketSlots``).  Elsewhere it takes the float32 plan's kernel
and its second launch.
"""

from __future__ import annotations

import ctypes

import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, TicketSlots,
                                         check_tensor, contiguous_counted,
                                         grad_wanted, raise_on, vector_units)

counters = LaunchCounters("fwd", "bwd")

# csrc/ln_rows.cuh's constants of the backward's plan
BWD_WARPS = 16           # a block: 16 warps, one block an SM
BWD_BLOCKS = 132         # blocks at most: an H100's SMs
BWD_MIN_ROWS = 8         # rows a block takes at least
BWD_LANE_FLOATS = 16     # floats of a row a lane holds, per input
BWD_LANE_SCALARS = 8     # the same in single floats
BWD_MAX_BATCH = 4        # rows a warp takes at once
BWD_MAX_C = 8 * 32 * BWD_LANE_FLOATS
PLAN_KEYS = ("vec", "units", "batch", "wpr", "blocks", "rows_per_block")

# csrc/ln.cu's constants of the bfloat16 backward in 16-byte units
# (ln_bwd_bf16x8): a block, blocks an SM, rows a row group takes at least,
# most blocks of a cluster, most units a lane holds of a row, lanes a row,
# the widest C
B16_THREADS = 256
B16_BLOCKS_PER_SM = 2
B16_MIN_STEPS = 1
B16_MAX_CLUSTER = 8
B16_MAX_UNITS = 3
B16_MIN_LANES, B16_MAX_LANES = 4, 128
B16_MAX_C = 2048
B16_PLAN_KEYS = ("lanes", "units", "csize", "chunk", "blocks")


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
    (vitta_tpu/ops/pallas_ln.py:55-73).  x and dy may be bfloat16: the
    arithmetic is float32, dx has x's dtype (rounded once), dgamma and
    dbeta are float32."""
    out_dtype = x.dtype
    x, dy = x.to(torch.float32), dy.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    mean_sq = torch.mean(torch.square(x), dim=-1, keepdim=True)
    rstd = torch.rsqrt(mean_sq - torch.square(mean) + eps)
    xh = (x - mean) * rstd
    wg = dy * gamma
    dx = rstd * (wg - torch.mean(wg, dim=-1, keepdim=True)
                 - xh * torch.mean(wg * xh, dim=-1, keepdim=True))
    return (dx.to(out_dtype), torch.sum(dy * xh, dim=0),
            torch.sum(dy, dim=0))


def ln_bwd_plan(rows: int, c: int, vec: int) -> dict:
    """How the backward kernel cuts (rows, C) (csrc/ln_rows.cuh:
    ln_bwd_plan): ``vec`` 1 for float4 units (C % 4 == 0), 0 for single
    floats; ``wpr`` warps a row, each lane holding ``units`` units of it;
    ``batch`` rows a warp takes at once (where wpr is 1); ``blocks`` blocks
    of ``rows_per_block`` contiguous rows (the last may have fewer), one
    partial (2, C) each.  Raises where the kernel takes no such shape."""
    w = 4 if vec else 1
    if rows <= 0 or not 0 < c <= BWD_MAX_C or (vec and c % 4):
        raise ValueError(f"the LayerNorm backward takes rows > 0 and 0 < C "
                         f"<= {BWD_MAX_C} (a multiple of 4 in 16-byte "
                         f"units), got ({rows}, {c}), vec={vec}")
    n = c // w

    def per_lane(wpr):
        return -(-n // (32 * wpr))

    wpr = 1
    while per_lane(wpr) * w > (BWD_LANE_FLOATS if vec else BWD_LANE_SCALARS):
        wpr *= 2
    units = per_lane(wpr)
    if not vec:
        units = 1 << (units - 1).bit_length()      # 1, 2, 4 or 8
    batch = min(BWD_MAX_BATCH, BWD_LANE_FLOATS // (units * w)) \
        if wpr == 1 else 1
    blocks = min(BWD_BLOCKS, -(-rows // BWD_MIN_ROWS))
    per_block = -(-rows // blocks)
    return dict(vec=int(bool(vec)), units=units, batch=batch, wpr=wpr,
                blocks=-(-rows // per_block), rows_per_block=per_block)


def ln_bwd_bf16_plan(rows: int, c: int, resident: int, sms: int) -> dict:
    """How the bfloat16 backward in 16-byte units cuts (rows, C), as
    ``ln_bwd_bf16_plan`` in csrc/ln.cu: a row is ``lanes`` lanes (4 to 128,
    a power of two), each holding ``units`` (at most 3) units of 8 values
    of it, units lane, lane + lanes, ...; a block of 256 threads is 256 /
    lanes row groups, group g taking at step s the row r0 + s * groups + g
    of its ``chunk`` contiguous rows (the rows shared evenly over the wave,
    at least a row a group; a warp whose rows run out stops); ``blocks``
    blocks (a multiple of ``csize``, the last may
    have no rows) in clusters of ``csize`` (up to 8, no more than the blocks
    with rows).  All blocks fit in one wave: at most ``resident`` clusters
    of 8 (what the card holds of the instance at once) and two blocks an SM
    of ``sms``.  Raises where the kernel takes no such shape."""
    if rows <= 0 or c <= 0 or c % 8 or c > B16_MAX_C:
        raise ValueError(f"the bfloat16 LayerNorm backward in 16-byte units "
                         f"takes rows > 0 and C a multiple of 8 up to "
                         f"{B16_MAX_C}, got ({rows}, {c})")
    cdiv = lambda a, b: -(-a // b)
    n = c // 8
    lanes = B16_MIN_LANES
    while lanes < B16_MAX_LANES and cdiv(n, lanes) > B16_MAX_UNITS:
        lanes *= 2
    groups = B16_THREADS // lanes
    wave = min(resident * B16_MAX_CLUSTER, B16_BLOCKS_PER_SM * sms)
    chunk = max(cdiv(rows, wave), B16_MIN_STEPS * groups)
    nb = cdiv(rows, chunk)
    csize = B16_MAX_CLUSTER
    while csize > 1 and csize > nb:
        csize //= 2
    return dict(zip(B16_PLAN_KEYS, (lanes, cdiv(n, lanes), csize, chunk,
                                    cdiv(nb, csize) * csize)))


# csrc/ln_rows.cuh's constants of the bfloat16 forward in 16-byte units
# (ln_fwd_bf16x8): a block, most units a lane holds below 32 lanes a row,
# most lanes a row (one warp), the widest C, and the widest rows taken
# F16_BATCH at a time
F16_THREADS = 128
F16_MAX_UNITS = 3
F16_MAX_LANES = 32
F16_MAX_C = 2048
F16_BATCH_C, F16_BATCH = 256, 2
F16_PLAN_KEYS = ("lanes", "units", "batch", "chunk", "blocks")


def ln_fwd_bf16_plan(rows: int, c: int, per_sm: int, sms: int) -> dict:
    """How the bfloat16 forward in 16-byte units cuts (rows, C), as
    ``ln_fwd_bf16_plan`` in csrc/ln_rows.cuh: a row is ``lanes`` lanes of
    one warp (4 to 32, a power of two: the fewest with at most 3 units a
    lane, else 32), each holding ``units`` units of 8 values of it, units
    lane, lane + lanes, ...; its sums are each lane's over its units in
    order, then a butterfly over its lanes.  A block of 128 threads is 128
    / lanes row groups, group g taking at step s the ``batch`` rows (2
    where 8 units lanes <= 256, else 1) from
    r0 + (s * groups + g) * batch of its ``chunk`` contiguous rows; the
    rows are shared evenly over one wave (``per_sm`` blocks an SM of
    ``sms``), a block taking at least a step's rows.  Raises where the
    kernel takes no such shape."""
    if rows <= 0 or c <= 0 or c % 8 or c > F16_MAX_C:
        raise ValueError(f"the bfloat16 LayerNorm forward in 16-byte units "
                         f"takes rows > 0 and C a multiple of 8 up to "
                         f"{F16_MAX_C}, got ({rows}, {c})")
    cdiv = lambda a, b: -(-a // b)
    n = c // 8
    lanes = 4
    while lanes < F16_MAX_LANES and cdiv(n, lanes) > F16_MAX_UNITS:
        lanes *= 2
    units = cdiv(n, lanes)
    batch = F16_BATCH if 8 * units * lanes <= F16_BATCH_C else 1
    step = F16_THREADS // lanes * batch
    chunk = max(cdiv(rows, per_sm * sms), step)
    return dict(zip(F16_PLAN_KEYS, (lanes, units, batch, chunk,
                                    cdiv(rows, chunk))))


ACT_DTYPES = (torch.float32, torch.bfloat16)   # x, y, dy, dx


def fwd_vec_bf16(c: int, *tensors) -> int:
    """1 where the bfloat16 forward takes 16-byte units of 8 values
    (ln_fwd_bf16x8: C % 8 == 0, C <= 2048, every tensor 16-byte aligned),
    else 0 (one value at a time)."""
    return int(c <= F16_MAX_C and bool(vector_units(c, 8, *tensors)))


def bwd_vec(c: int, *tensors) -> int:
    """1 where the backward takes units of 4 elements (16 bytes of
    float32, 8 of bfloat16): C % 4 == 0 and every tensor starts on a
    boundary of its unit; else 0 (single elements)."""
    return vector_units(c, 4, *tensors)


def bwd_vec_bf16(c: int, *tensors) -> int:
    """The bfloat16 backward's units: 2 where it takes 16-byte units of 8
    values in one launch (C % 8 == 0, C <= 2048, every tensor 16-byte
    aligned), else ``bwd_vec``'s 1 (units of 4 values, 8 bytes) or 0."""
    if c <= B16_MAX_C and vector_units(c, 8, *tensors):
        return 2
    return bwd_vec(c, *tensors)


# the slot of the bfloat16 backward's tickets each (device, stream) uses
ticket_slot = TicketSlots("bfloat16 LayerNorm backward")

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
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, p]
        lib.vitta_ln_bwd.restype = ctypes.c_int
        lib.vitta_ln_bwd_scratch_floats.argtypes = [ctypes.c_longlong,
                                                    ctypes.c_int]
        lib.vitta_ln_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_ln_bwd_plan.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, p]
        lib.vitta_ln_bwd_plan.restype = None
        lib.vitta_ln_fwd_bf16.argtypes = lib.vitta_ln_fwd.argtypes
        lib.vitta_ln_fwd_bf16.restype = ctypes.c_int
        lib.vitta_ln_bwd_bf16.argtypes = lib.vitta_ln_bwd.argtypes[:-1] + [
            ctypes.c_int, p]
        lib.vitta_ln_bwd_bf16.restype = ctypes.c_int
        lib.vitta_ln_bwd_bf16_plan.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int, p]
        lib.vitta_ln_bwd_bf16_plan.restype = None
        lib.vitta_ln_fwd_bf16_plan.argtypes = \
            lib.vitta_ln_bwd_bf16_plan.argtypes
        lib.vitta_ln_fwd_bf16_plan.restype = None
        lib.vitta_ln_bwd_bf16_scratch_floats.argtypes = \
            lib.vitta_ln_bwd_scratch_floats.argtypes
        lib.vitta_ln_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_ln_slots.argtypes = []
        lib.vitta_ln_slots.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def ln_fwd_cuda(x2, gamma, beta, eps: float = 1e-5):
    """Forward kernel on ``x2`` (R, C), float32 or bfloat16: one launch,
    output allocated here at x's dtype."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x2.shape)}")
    rows, c = x2.shape
    check_tensor("LayerNorm", "x", x2, (rows, c), x2.device,
                 dtypes=ACT_DTYPES)
    check_tensor("LayerNorm", "gamma", gamma, (c,), x2.device)
    check_tensor("LayerNorm", "beta", beta, (c,), x2.device)
    y = torch.empty_like(x2)
    lib = _lib()
    fwd = lib.vitta_ln_fwd_bf16 if x2.dtype == torch.bfloat16 \
        else lib.vitta_ln_fwd
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        code = fwd(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   y.data_ptr(), rows, c, float(eps), stream)
    raise_on(code, "LayerNorm forward kernel")
    counters.fwd += 1
    return y


def ln_bwd_plan_cuda(rows: int, c: int, vec: int) -> dict:
    """The backward kernel's own plan, from csrc/ln_rows.cuh (units 0 where
    it takes no such shape)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    _lib().vitta_ln_bwd_plan(rows, c, int(vec), out)
    return dict(zip(PLAN_KEYS, out))


def ln_bwd_bf16_plan_cuda(rows: int, c: int) -> dict:
    """The bfloat16 backward's own plan in 16-byte units, from csrc/ln.cu
    (units 0 where it takes no such shape), with what it was made for: the
    clusters of 8 blocks of its instance the card holds at once
    (``resident``) and the card's SMs (``sms``)."""
    keys = B16_PLAN_KEYS + ("resident", "sms")
    out = (ctypes.c_longlong * len(keys))()
    _lib().vitta_ln_bwd_bf16_plan(rows, c, out)
    return dict(zip(keys, out))


def ln_fwd_bf16_plan_cuda(rows: int, c: int) -> dict:
    """The bfloat16 forward's own plan in 16-byte units, from
    csrc/ln_rows.cuh (units 0 where it takes no such shape), with what it
    was made for: the blocks of its instance an SM holds (``per_sm``) and
    the card's SMs (``sms``)."""
    keys = F16_PLAN_KEYS + ("per_sm", "sms")
    out = (ctypes.c_longlong * len(keys))()
    _lib().vitta_ln_fwd_bf16_plan(rows, c, out)
    return dict(zip(keys, out))


def ln_bwd_cuda(x2, gamma, dy, eps: float = 1e-5):
    """Backward kernels on ``x2`` (R, C) and the cotangent ``dy`` (R, C);
    returns (dx, dgamma, dbeta), allocated here with the scratch.  x and dy
    float32, or both bfloat16 (dx then bfloat16, dgamma and dbeta float32).
    At bfloat16 in 16-byte units (``bwd_vec_bf16`` 2): one launch on the
    current stream, which also adds the blocks' column sums, with the
    stream's slot of tickets.  Otherwise two launches (dx with the blocks'
    partial column sums, then their sum), units of 4 elements where
    ``bwd_vec`` says so, single elements otherwise."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x2.shape)}")
    rows, c = x2.shape
    if rows == 0:
        raise ValueError("x has no rows")
    check_tensor("LayerNorm", "x", x2, (rows, c), x2.device,
                 dtypes=ACT_DTYPES)
    check_tensor("LayerNorm", "gamma", gamma, (c,), x2.device)
    check_tensor("LayerNorm", "grad", dy, (rows, c), x2.device,
                 dtypes=(x2.dtype,))
    if c > BWD_MAX_C:
        raise ValueError(f"the LayerNorm backward takes C up to {BWD_MAX_C}, "
                         f"got {c}")
    lib = _lib()
    dx = torch.empty_like(x2)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    ptrs = (x2.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dgb.data_ptr())
    if x2.dtype == torch.bfloat16:
        vec = bwd_vec_bf16(c, x2, gamma, dy, dx)
        floats = (lib.vitta_ln_bwd_bf16_scratch_floats(rows, c) if vec == 2
                  else lib.vitta_ln_bwd_scratch_floats(rows, c))
        slot = (ticket_slot(x2.device, stream, lib.vitta_ln_slots())
                if vec == 2 else 0)
        scratch = torch.empty(floats, dtype=torch.float32, device=x2.device)
        with torch.cuda.device(x2.device):
            code = lib.vitta_ln_bwd_bf16(*ptrs, scratch.data_ptr(), rows, c,
                                         float(eps), vec, slot, stream)
    else:
        vec = bwd_vec(c, x2, gamma, dy, dx)
        scratch = torch.empty(lib.vitta_ln_bwd_scratch_floats(rows, c),
                              dtype=torch.float32, device=x2.device)
        with torch.cuda.device(x2.device):
            code = lib.vitta_ln_bwd(*ptrs, scratch.data_ptr(), rows, c,
                                    float(eps), vec, stream)
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
    than float32 or bfloat16 or a non-contiguous input."""
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
