"""The Video Swin MLP with the LayerNorm in front of it (``ln_mlp``) and
without (``mlp``), forward and backward: CUDA kernels, plain versions,
autograd wrappers.

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
version.

``mlp`` is the same op without the LayerNorm, ``o = fc2(gelu(fc1(x)))``,
for the widths whose norm2 runs as a LayerNorm of its own
(ops/dispatch.py:``mlp_ln_fused``): the counterpart of ``fused_mlp``
(pallas_mlp.py:657), with ``mlp_reference`` (:272) as its plain version
and the kernels ``vitta_mlp_fwd`` / ``vitta_mlp_bwd`` of the same source
as the counterparts of pallas_mlp.py:138 and :154.  When a gradient is
wanted it keeps (x, w1, w2, a, s) (pallas_mlp.py:256-258); otherwise the
forward writes no s and keeps nothing (:249-253).

At bfloat16 (x, the four MLP weights and biases, y, a, s, o and every
gradient but dgamma and dbeta bfloat16; gamma, beta and every sum float32)
the kernels are ``vitta_lnmlp_{fwd,bwd}_bf16``, the counterparts of the same
Pallas kernels at the compute dtype, and round where they do
(pallas_mlp.py:303-353, VJP :605-613): y before y w1^T, a and s once each,
o once; dh = (go w2) * s in float32, rounded (dhc) before dy and dw1; dy +
gy in float32; dx, dw1, db1, dw2 and db2 once.  ``mlp`` at bfloat16 runs
``vitta_mlp_{fwd,bwd}_bf16``, the counterparts of pallas_mlp.py:138 and
:154 at the compute dtype (VJP :261-266), with the same rounding on x
itself, and dx = dhc w1 rounded once; ``mlp_bf16_reference`` and
``mlp_bf16_backward_reference`` are their plain versions.  The LayerNorm-MLP
runs its six products on the bfloat16 wgmma core
(csrc/gemm_wgmma_bf16.cuh), cut as ``bf16_gemm_plan`` says.  ``mlp`` at
Swin-T's widths (C 48, 96 or 192 and F = 4C,
``mlp_bf16_fused``) runs csrc/mlp_fused_bf16.cuh as ``mlp_rows_plan``
cuts it: the forward in one launch that writes a and s only when a
gradient will read them, the backward as one row pass (dh, dhc, dx and
the bias gradients' partials per 64 rows), dw1 and dw2 on the core and one
ordered reduce (3 launches); at other widths the core's products on x.
The plain versions round at the same points, and
on the CPU a bfloat16 ``ln_mlp`` or ``mlp`` runs the plain forward and the
plain backward as one autograd Function, so that it rounds where the
kernels do (at float32 the CPU keeps torch's autograd of the plain
forward).

There is no fallback: a CUDA tensor a kernel does not take raises.
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

# fwd, bwd: the LayerNorm-MLP kernels; mlp_fwd, mlp_bwd: those without the
# LayerNorm
counters = LaunchCounters("fwd", "bwd", "mlp_fwd", "mlp_bwd")

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def gelu_derivative(h):
    """Phi(h) + h * phi(h), the exact GELU's derivative (pallas_mlp.py:
    ``_gelu_parts``), on float32 ``h``."""
    phi = 0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
    return phi + h * torch.exp(-0.5 * h * h) * _INV_SQRT_2PI


def _rounded_mlp(x, w1, b1, w2, b2):
    """(o, a, s) of fc1 -> exact GELU -> fc2 on ``x`` as the kernels make
    them at x's dtype: float32 arithmetic, a, s and o rounded once each (at
    float32 every cast is the identity)."""
    dt, f32 = x.dtype, torch.float32
    h = F.linear(x.to(f32), w1.to(f32), b1.to(f32))
    a = F.gelu(h).to(dt)
    o = F.linear(a.to(f32), w2.to(f32), b2.to(f32)).to(dt)
    return o, a, gelu_derivative(h).to(dt)


def _rounded_mlp_backward(x, a, s, go, w1, w2):
    """(dhc w1 float32, dw1, db1, dw2, db2) of the MLP on ``x`` for the
    cotangent ``go`` of o, as the kernels make them at x's dtype: dh =
    (go w2) * s in float32, rounded (dhc) before the two products that read
    it, and the weight and bias gradients rounded once."""
    dt, f32 = x.dtype, torch.float32
    go32 = go.to(f32)
    dh = (go32 @ w2.to(f32)) * s.to(f32)
    dhc = dh.to(dt).to(f32)
    return (dhc @ w1.to(f32), (dhc.t() @ x.to(f32)).to(dt),
            dh.sum(dim=0).to(dt), (go32.t() @ a.to(f32)).to(dt),
            go32.sum(dim=0).to(dt))


def ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                     save_residuals: bool = False):
    """The unfused composition on ``x`` (..., C); returns (o, y), and with
    ``save_residuals`` (o, y, a, s).  At bfloat16 (x and the MLP weights)
    the arithmetic is float32 and y, a, s and o are rounded where the
    kernels round them; at float32 every cast is the identity."""
    y = layer_norm_reference(x, gamma, beta, eps)
    o, a, s = _rounded_mlp(y, w1, b1, w2, b2)
    return (o, y, a, s) if save_residuals else (o, y)


def ln_mlp_backward_reference(x, y, a, s, go, gy, gamma, w1, w2,
                              eps: float = 1e-5):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) for the cotangents ``go`` of
    o and ``gy`` of y (or None), written out from what the forward keeps
    as the kernel computes it (pallas_mlp.py:322-369); all of (M, C) or
    (M, F).  At bfloat16 the arithmetic is float32, dh is rounded (dhc)
    before the two products that read it, and dx and the weight and bias
    gradients are rounded once; dgamma and dbeta are float32."""
    dy, dw1, db1, dw2, db2 = _rounded_mlp_backward(y, a, s, go, w1, w2)
    if gy is not None:
        dy = dy + gy.to(torch.float32)
    dx, dgamma, dbeta = layer_norm_backward_reference(x, gamma, dy, eps)
    return dx.to(x.dtype), dgamma, dbeta, dw1, db1, dw2, db2


def mlp_bf16_reference(x, w1, b1, w2, b2, save_residuals: bool = False):
    """The MLP without the LayerNorm at bfloat16 (x and the weights and
    biases bfloat16) as its kernel computes it (pallas_mlp.py:138-151 at
    the compute dtype): h = x w1^T + b1 in float32, a and s rounded once,
    o = bfloat16(a) w2^T + b2 rounded once.  Returns o, and with
    ``save_residuals`` (o, a, s)."""
    o, a, s = _rounded_mlp(x, w1, b1, w2, b2)
    return (o, a, s) if save_residuals else o


def mlp_bf16_backward_reference(x, a, s, g, w1, w2):
    """(dx, dw1, db1, dw2, db2), all bfloat16, for the cotangent ``g`` of o
    at bfloat16, from what the forward keeps, as the kernel computes them
    (pallas_mlp.py:154-183, VJP :261-266): dh = (g w2) * s in float32, dhc
    its rounded form, dx = dhc w1, dw1 = dhc^T x, dw2 = g^T a, db1 = sum dh
    and db2 = sum g in float32, each rounded once."""
    dx, dw1, db1, dw2, db2 = _rounded_mlp_backward(x, a, s, g, w1, w2)
    return dx.to(x.dtype), dw1, db1, dw2, db2


def mlp_reference(x, w1, b1, w2, b2, save_residuals: bool = False):
    """fc1 -> exact GELU -> fc2 on ``x`` (..., C); with ``save_residuals``
    (o, a, s), a and s being the GELU's value and derivative."""
    h = F.linear(x, w1, b1)
    a = F.gelu(h)
    o = F.linear(a, w2, b2)
    if not save_residuals:
        return o
    return o, a, gelu_derivative(h)


def mlp_backward_reference(x, a, s, g, w1, w2):
    """(dx, dw1, db1, dw2, db2) for the cotangent ``g`` of o, written out
    from what the forward keeps as the kernel computes it
    (pallas_mlp.py:154-183); x, g (M, C), a, s (M, F)."""
    dh = (g @ w2) * s
    return dh @ w1, dh.t() @ x, dh.sum(dim=0), g.t() @ a, g.sum(dim=0)


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
        lib.vitta_mlp_fwd.argtypes = [p] * 8 + [i, i, i, p]
        lib.vitta_mlp_fwd.restype = i
        lib.vitta_mlp_bwd.argtypes = [p] * 12 + [i, i, i, p]
        lib.vitta_mlp_bwd.restype = i
        lib.vitta_mlp_bwd_scratch_floats.argtypes = [i, i, i]
        lib.vitta_mlp_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_lnmlp_fwd_bf16.argtypes = lib.vitta_lnmlp_fwd.argtypes
        lib.vitta_lnmlp_fwd_bf16.restype = i
        lib.vitta_lnmlp_bwd_bf16.argtypes = lib.vitta_lnmlp_bwd.argtypes
        lib.vitta_lnmlp_bwd_bf16.restype = i
        lib.vitta_lnmlp_bwd_bf16_scratch_floats.argtypes = [i, i, i]
        lib.vitta_lnmlp_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_lnmlp_bwd_bf16_plan.argtypes = [
            i, i, i, ctypes.POINTER(ctypes.c_longlong)]
        lib.vitta_lnmlp_bwd_bf16_plan.restype = None
        lib.vitta_lnmlp_bf16_plan.argtypes = [i, i, i,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.vitta_lnmlp_bf16_plan.restype = None
        lib.vitta_lnmlp_bf16_product.argtypes = [i] + [p] * 8 + [i, i, i, p]
        lib.vitta_lnmlp_bf16_product.restype = i
        lib.vitta_lnmlp_bf16_product_scratch_floats.argtypes = [i, i, i, i]
        lib.vitta_lnmlp_bf16_product_scratch_floats.restype = \
            ctypes.c_longlong
        lib.vitta_mlp_fwd_bf16.argtypes = lib.vitta_mlp_fwd.argtypes
        lib.vitta_mlp_fwd_bf16.restype = i
        lib.vitta_mlp_bwd_bf16.argtypes = [p] * 13 + [i, i, i, p]
        lib.vitta_mlp_bwd_bf16.restype = i
        lib.vitta_mlp_bwd_bf16_scratch_floats.argtypes = [i, i, i]
        lib.vitta_mlp_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
        lib.vitta_mlp_bwd_bf16_launches.argtypes = [i, i, i]
        lib.vitta_mlp_bwd_bf16_launches.restype = i
        lib.vitta_mlp_bf16_rows_plan.argtypes = [
            i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.vitta_mlp_bf16_rows_plan.restype = None
        _LIB = lib
    return _LIB


# The six products of the bfloat16 kernels, in the order the library's plan
# gives them, each as C (M, N) over K from (m, c, f): h = y w1^T, o = a
# w2^T, dh = go w2, dy = dhc w1, dw1 = dhc^T y, dw2 = go^T a.
BF16_PRODUCTS = ("h", "o", "dh", "dy", "dw1", "dw2")
BF16_PLAN_KEYS = ("bm", "bn", "splits", "kchunk", "grid", "smem")
_SLICE = 64           # k depth of the core's slices (gemm_wgmma_bf16.cuh)
_GRAD_ROWS = 512      # a weight gradient's chunk of K is at least this
# ring slots of the 128- and 64-row tiles (VITTA_WG_STAGES_128 / _64)
_STAGES = {128: 4, 64: 3}


def wgmma_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of a gemm_wgmma_bf16 block (WgShape::smem):
    1024 bytes of alignment slack, the ring of 64-deep slices of A and B
    (8192 bytes a 64 x 64 box), the consumers' float32 staging rows (64 x
    136 a warpgroup) and two mbarriers a slot."""
    return (1024 + stages * (bm + bn) // 64 * 8192
            + bm // 64 * 64 * 136 * 4 + 2 * stages * 8)


def bf16_product_dims(m: int, c: int, f: int):
    """{product: (M, N, K)} of the six bfloat16 products."""
    return {"h": (m, f, c), "o": (m, c, f), "dh": (m, f, c),
            "dy": (m, c, f), "dw1": (f, c, m), "dw2": (c, f, m)}


def bf16_gemm_plan(m: int, c: int, f: int, sms: int = 132):
    """How the bfloat16 core cuts each product on a card of ``sms`` SMs, as
    ``wg_row_plan`` / ``wg_grad_plan`` in csrc/gemm_wgmma_bf16.cuh:
    {product: {bm, bn, splits, kchunk, grid, smem}} (``wgmma_plan``)."""
    return wgmma_plan(bf16_product_dims(m, c, f), ("dw1", "dw2"), sms)


def wgmma_plan(dims, grads, sms: int = 132):
    """The plans of the products ``dims`` ({product: (M, N, K)}), of which
    the two named in ``grads`` are weight gradients that share one launch:
    {product: {bm, bn, splits, kchunk, grid, smem}}.  A row product takes
    64 x 128 tiles (two blocks an SM) where cdiv(t64, sms) < 2 cdiv(t128,
    sms), or the two tie and t128 < 2 sms, else 128 x 128 (one), over all
    of K; the two weight gradients, in one launch, 128 x 128 tiles and
    min(sms // their tiles, K // 512) chunks of K each (at least one), a
    multiple of 64 long, added in chunk order; the launch's grid is
    min(their work items, SMs)."""
    cdiv = lambda a, b: -(-a // b)
    grad_tiles = sum(cdiv(dims[k][0], 128) * cdiv(dims[k][1], 128)
                     for k in grads)
    plan, work = {}, {}
    for name, (mm, nn, kk) in dims.items():
        if name in grads:
            bm = 128
            splits = min(max(sms // grad_tiles, 1),
                         max(kk // _GRAD_ROWS, 1))
        else:
            t128 = cdiv(mm, 128) * cdiv(nn, 128)
            t64 = cdiv(mm, 64) * cdiv(nn, 128)
            w64, w128 = cdiv(t64, sms), 2 * cdiv(t128, sms)
            bm = 64 if w64 < w128 or (w64 == w128 and t128 < 2 * sms) \
                else 128
            splits = 1
        kchunk = cdiv(cdiv(kk, splits), _SLICE) * _SLICE
        splits = cdiv(kk, kchunk)
        work[name] = cdiv(mm, bm) * cdiv(nn, 128) * splits
        grid = min(work[name], (2 if bm == 64 else 1) * sms)
        plan[name] = dict(zip(BF16_PLAN_KEYS, (
            bm, 128, splits, kchunk, grid,
            wgmma_smem_bytes(bm, 128, _STAGES[bm]))))
    # the two weight gradients share one launch: its grid
    for name in grads:
        plan[name]["grid"] = min(sum(work[k] for k in grads), sms)
    return plan


def bf16_bwd_launches(m: int, c: int, f: int, sms: int = 132,
                      ln: bool = True) -> int:
    """Launches of one bfloat16 backward call.  Without the LayerNorm at the
    fused widths (``mlp_bf16_fused``): the row pass, both weight gradients
    in one launch, one ordered reduce.  Else: dh with db1's column
    partials, their ordered sum, dy (dx without the LayerNorm), both weight
    gradients in one launch and the ordered sums of those whose plan cuts
    K, db2's column sums (two) and, with ``ln``, the LayerNorm backward
    (two)."""
    if not ln and mlp_bf16_fused(c, f):
        return 3
    plan = bf16_gemm_plan(m, c, f, sms)
    return (8 if ln else 6) + sum(plan[k]["splits"] > 1
                                  for k in ("dw1", "dw2"))


# The fused kernels of the MLP without the LayerNorm
# (csrc/mlp_fused_bf16.cuh): tiles of 128 rows, F in chunks of 64, the
# widths they take, the shared memory a block may have, a ring's most slots
MF_ROWS, MF_CHUNK, MF_WIDTHS = 128, 64, (48, 96, 192)
MF_SMEM_MAX, MF_MAX_SLOTS, MF_BOX = 232448, 4, 8192
ROWS_PLAN_KEYS = ("fused", "rows", "chunk", "tiles", "grid", "fwd_a",
                  "fwd_s", "fwd_b", "fwd_smem", "bwd_a", "bwd_s", "bwd_b",
                  "bwd_smem")


def mlp_bf16_fused(c: int, f: int) -> bool:
    """Whether the bfloat16 ``mlp`` runs its fused kernels at widths (C,
    F): C 48, 96 or 192 and F = 4C, Swin's MLP ratio (``mlp_fused``)."""
    return c in MF_WIDTHS and f == 4 * c


def mlp_rows_smem(c: int, bwd: bool):
    """(slots of rings A, S, B, dynamic shared memory in bytes) of a block
    of the fused forward (``bwd`` False) or row pass (MfShape, mf_fit):
    1024 bytes of slack, the x or g tile of two warpgroups (64 x 64 boxes
    of 8192 bytes, cdiv(C, 64) a row of boxes), each warpgroup's store
    buffers (a and s; dhc), the row
    pass's per-warp column sums (2 x 4 x 64 floats) and two warpgroups'
    running column sums of dh and g (2 x 5C floats), 28 mbarriers; ring A
    (the first product's weight chunk) and B (the second's) of cdiv(C, 64)
    boxes a slot, S (the row pass's s of both warpgroups) of 2.  Each ring
    starts at 4 slots; while the block passes 232448 bytes the ring with
    the most gives one up (A, then S, then B on a tie)."""
    nc = -(-c // 64)
    fixed = (1024 + 2 * nc * MF_BOX + 2 * (1 if bwd else 2) * MF_BOX
             + (2 * 4 * MF_CHUNK * 4 + 2 * 5 * c * 4 if bwd else 0)
             + 8 * (2 * 3 * MF_MAX_SLOTS + 4))
    q = [MF_MAX_SLOTS, MF_MAX_SLOTS if bwd else 0, MF_MAX_SLOTS]
    size = lambda: fixed + (q[0] + q[2]) * nc * MF_BOX + q[1] * 2 * MF_BOX
    while size() > MF_SMEM_MAX:
        q[q.index(max(q))] -= 1
    return (*q, size())


def mlp_rows_plan(m: int, c: int, f: int, sms: int = 132):
    """How the fused kernels cut (M, C, F) on a card of ``sms`` SMs, as
    ``vitta_mlp_bf16_rows_plan`` reports it: {fused, rows, chunk, tiles,
    grid, then fwd_ and bwd_ a, s, b, smem} (-1 each but fused where the
    widths are not fused): tiles of 128 rows over min(tiles, SMs)
    persistent blocks, F in chunks of 64, the rings' slots and shared
    memory of ``mlp_rows_smem``."""
    if not mlp_bf16_fused(c, f):
        return dict(zip(ROWS_PLAN_KEYS, (0,) + (-1,) * 12))
    tiles = -(-m // MF_ROWS)
    return dict(zip(ROWS_PLAN_KEYS, (1, MF_ROWS, MF_CHUNK, tiles,
                                     min(tiles, sms), *mlp_rows_smem(c, False),
                                     *mlp_rows_smem(c, True))))


def mlp_rows_plan_cuda(m: int, c: int, f: int):
    """The library's own ``mlp_rows_plan`` on this card."""
    out = (ctypes.c_int * len(ROWS_PLAN_KEYS))()
    _lib().vitta_mlp_bf16_rows_plan(m, c, f, out)
    return dict(zip(ROWS_PLAN_KEYS, out))


def bf16_gemm_plan_cuda(m: int, c: int, f: int):
    """The library's own plan of the six products on this card (the same
    keys as ``bf16_gemm_plan``), for the LayerNorm-MLP and the MLP without
    the LayerNorm alike (the latter's dy is its dx)."""
    k = len(BF16_PLAN_KEYS)
    out = (ctypes.c_int * (k * len(BF16_PRODUCTS)))()
    _lib().vitta_lnmlp_bf16_plan(m, c, f, out)
    return {name: dict(zip(BF16_PLAN_KEYS, out[k * i:k * i + k]))
            for i, name in enumerate(BF16_PRODUCTS)}


def mlp_bf16_bwd_launches_cuda(m: int, c: int, f: int) -> int:
    """The library's count of the launches one bfloat16 ``mlp`` backward
    makes on this card (``bf16_bwd_launches(..., ln=False)`` mirrors it)."""
    return _lib().vitta_mlp_bwd_bf16_launches(m, c, f)


def bf16_product_cuda(name: str, a, b, bias=None, aux=None, lib=None):
    """One of the six bfloat16 products alone, by the plan the kernels use,
    on the current stream (for timing and checks: chip_smoke.py phase 21,
    tools/gemm_variants.py; the port's path runs them inside
    ``ln_mlp_fwd_cuda`` / ``ln_mlp_bwd_cuda``).  ``a`` and ``b`` as that
    product reads them (h: y, w1; o: a, w2; dh: go, w2; dy: dhc, w1; dw1:
    dhc, y; dw2: go, a), ``bias`` b1 or b2, ``aux`` s (dh) or gy (dy).
    Returns h: (a, s); o: o; dh: (dh float32, dhc); dy: dy float32; dw1,
    dw2: the gradient.  ``lib``: another build of csrc/mlp.cu (the
    variants tool's)."""
    which = BF16_PRODUCTS.index(name)
    for label, ten in (("a", a), ("b", b), ("bias", bias), ("aux", aux)):
        if ten is not None:
            check_tensor(f"bfloat16 product {name}", label, ten, ten.shape,
                         a.device, dtypes=(torch.bfloat16,))
    # (C, F) from the operands' shapes; a's rows are M
    m, (ar, ac), (br, bc) = a.shape[0], a.shape, b.shape
    c, f = {"h": (ac, br), "o": (br, ac), "dh": (ac, bc), "dy": (bc, ac),
            "dw1": (bc, ac), "dw2": (ac, bc)}[name]
    mm, nn, _kk = bf16_product_dims(m, c, f)[name]
    dev = a.device
    lib = lib or _lib()
    new = lambda dt: torch.empty((mm, nn), dtype=dt, device=dev)
    out_f = new(torch.float32) if name in ("dh", "dy") else None
    out_b = None if name == "dy" else new(torch.bfloat16)
    out_s = new(torch.bfloat16) if name == "h" else None
    floats = lib.vitta_lnmlp_bf16_product_scratch_floats(which, m, c, f)
    if floats < 0:
        raise ValueError(f"no bfloat16 product {name} for M={m}, C={c}, "
                         f"F={f}")
    partial = (torch.empty(floats, dtype=torch.float32, device=dev)
               if floats else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.vitta_lnmlp_bf16_product(
            which, ptr(a), ptr(b), ptr(bias), ptr(aux), ptr(out_f),
            ptr(out_b), ptr(out_s), ptr(partial), m, c, f, stream)
    raise_on(code, f"bfloat16 product {name}")
    return {"h": (out_b, out_s), "o": out_b, "dh": (out_f, out_b),
            "dy": out_f}.get(name, out_b)


# the parameters that stay float32 at bfloat16
_F32_NAMES = ("gamma", "beta")


def _check(x2, w1, named, what="LayerNorm-MLP", bf16=False):
    """Raise on anything the kernels do not take; ``named`` lists
    (name, tensor, shape as a string of m, c, f).  With ``bf16`` every
    tensor but gamma and beta is bfloat16, C and F are multiples of 8 and
    every tensor starts on a 16-byte boundary.  Returns (M, C, F)."""
    if x2.dim() != 2:
        raise ValueError(f"x must be (M, C), got shape {tuple(x2.shape)}")
    m, c = x2.shape
    f = w1.shape[0]
    dims = {"m": m, "c": c, "f": f}
    for name, ten, shape in named:
        dtype = torch.bfloat16 if bf16 and name not in _F32_NAMES \
            else torch.float32
        check_tensor(what, name, ten, tuple(dims[d] for d in shape),
                     x2.device, dtypes=(dtype,))
        if bf16 and ten.data_ptr() % 16:
            raise ValueError(f"the bfloat16 {what} kernels take tensors "
                             f"that start on a 16-byte boundary; {name} "
                             f"does not")
    unit = 8 if bf16 else 4
    if c % unit != 0 or f % unit != 0:
        raise ValueError(f"the {what} kernels take C and F that are "
                         f"multiples of {unit} (16-byte rows); got C={c}, "
                         f"F={f}")
    if m == 0:
        raise ValueError("x has no rows")
    return m, c, f


def ln_mlp_fwd_cuda(x2, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                    save_residuals: bool = False):
    """Forward kernels on ``x2`` (M, C): one wrapper call, three launches
    on the current stream; outputs and the (M, F) scratch allocated here,
    at x's dtype (float32, or bfloat16 with bfloat16 MLP weights)."""
    bf16 = x2.dtype == torch.bfloat16
    m, c, f = _check(x2, w1, (("x", x2, "mc"), ("gamma", gamma, "c"),
                              ("beta", beta, "c"), ("w1", w1, "fc"),
                              ("b1", b1, "f"), ("w2", w2, "cf"),
                              ("b2", b2, "c")), bf16=bf16)
    dev = x2.device
    y = torch.empty_like(x2)
    o = torch.empty_like(x2)
    a = torch.empty((m, f), dtype=x2.dtype, device=dev)
    s = torch.empty_like(a) if save_residuals else None
    lib = _lib()
    fwd = lib.vitta_lnmlp_fwd_bf16 if bf16 else lib.vitta_lnmlp_fwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fwd(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            a.data_ptr(), None if s is None else s.data_ptr(), o.data_ptr(),
            m, c, f, float(eps), stream)
    raise_on(code, "LayerNorm-MLP forward kernel")
    counters.fwd += 1
    return (o, y, a, s) if save_residuals else (o, y)


def ln_mlp_bwd_scratch_floats(m: int, c: int, f: int, dtype) -> int:
    """Floats of scratch the backward kernels take at ``dtype``."""
    lib = _lib()
    return (lib.vitta_lnmlp_bwd_bf16_scratch_floats
            if dtype == torch.bfloat16
            else lib.vitta_lnmlp_bwd_scratch_floats)(m, c, f)


def bf16_bwd_scratch_views(scratch, m: int, c: int, f: int):
    """(dh (M, F) float32, dhc (M, F) bfloat16, dy (M, C) float32): the
    bfloat16 backward's intermediates as it leaves them in its float32
    ``scratch``, at the offsets the library gives
    (``vitta_lnmlp_bwd_bf16_plan``), for a check that holds each step to
    its plain version on the kernel's own inputs."""
    offsets = (ctypes.c_longlong * 3)()
    _lib().vitta_lnmlp_bwd_bf16_plan(m, c, f, offsets)
    dh_at, dhc_at, dy_at = offsets
    if dh_at < 0:
        raise ValueError(f"no bfloat16 LayerNorm-MLP backward for M={m}, "
                         f"C={c}, F={f}")
    mf = m * f
    dh = scratch[dh_at:dh_at + mf].view(m, f)
    dhc = scratch[dhc_at:dhc_at + mf // 2].view(torch.bfloat16).view(m, f)
    dy = scratch[dy_at:dy_at + m * c].view(m, c)
    return dh, dhc, dy


def ln_mlp_bwd_cuda(x2, y, a, s, go, gy, gamma, w1, w2, eps: float = 1e-5,
                    scratch=None):
    """Backward kernels: one wrapper call, its launches on the current
    stream; ``gy`` may be None (no cotangent on y).  Returns (dx, dgamma,
    dbeta, dw1, db1, dw2, db2), allocated here with the scratch (dh (M, F),
    dy (M, C) and the partial sums; ``scratch`` may be passed in, and at
    bfloat16 ``bf16_bwd_scratch_views`` reads dh, its rounded form and dy
    from it afterwards).  At bfloat16 every gradient but dgamma and dbeta
    is bfloat16."""
    bf16 = x2.dtype == torch.bfloat16
    named = [("x", x2, "mc"), ("y", y, "mc"), ("a", a, "mf"), ("s", s, "mf"),
             ("grad of o", go, "mc"), ("gamma", gamma, "c"),
             ("w1", w1, "fc"), ("w2", w2, "cf")]
    if gy is not None:
        named.append(("grad of y", gy, "mc"))
    m, c, f = _check(x2, w1, named, bf16=bf16)
    dev = x2.device
    lib = _lib()
    new = lambda *shape: torch.empty(shape, dtype=x2.dtype, device=dev)
    dx, dw1, db1, dw2, db2 = new(m, c), new(f, c), new(f), new(c, f), new(c)
    dgb = torch.empty((2, c), dtype=torch.float32, device=dev)
    floats = ln_mlp_bwd_scratch_floats(m, c, f, x2.dtype)
    if scratch is None:
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    elif (scratch.dtype != torch.float32 or scratch.device != dev
          or scratch.numel() < floats or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be {floats} contiguous float32 "
                         f"values on {dev}")
    bwd = lib.vitta_lnmlp_bwd_bf16 if bf16 else lib.vitta_lnmlp_bwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = bwd(
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


class LayerNormMlpPlain(torch.autograd.Function):
    """The plain forward and the plain backward as one differentiable op,
    the CPU's form at bfloat16: it rounds where the kernels round, forward
    and backward (``ln_mlp_reference``, ``ln_mlp_backward_reference``)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, eps):
        ctx.eps = eps
        o, y, a, s = ln_mlp_reference(x2, gamma, beta, w1, b1, w2, b2, eps,
                                      save_residuals=True)
        ctx.save_for_backward(x2, y, a, s, gamma, w1, w2)
        return o, y

    @staticmethod
    def backward(ctx, go, gy):
        x2, y, a, s, gamma, w1, w2 = ctx.saved_tensors
        return ln_mlp_backward_reference(x2, y, a, s, go, gy, gamma, w1, w2,
                                         ctx.eps) + (None,)


def ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
           save_residuals: bool = False):
    """(LayerNorm -> fc1 -> exact GELU -> fc2)(x) over the last axis of
    ``x`` (..., C); returns (o, y) in x's shape, and with
    ``save_residuals`` also a and s as (M, F).  x and the MLP weights and
    biases float32, or all bfloat16; gamma and beta float32.

    A CPU tensor takes the plain version (at bfloat16 with the plain
    backward, ``LayerNormMlpPlain``, where a gradient is wanted); a CUDA
    tensor takes the kernels (forward, and backward under autograd), which
    raise on any other dtype, a non-contiguous input, or a C or F that is
    not a multiple of 4 (8 at bfloat16)."""
    if x.device.type == "cpu":
        if (x.dtype == torch.bfloat16 and not save_residuals
                and grad_wanted(x, gamma, beta, w1, b1, w2, b2)):
            c = x.shape[-1]
            o, y = LayerNormMlpPlain.apply(x.reshape(-1, c), gamma, beta, w1,
                                           b1, w2, b2, float(eps))
            return o.reshape(x.shape), y.reshape(x.shape)
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


def mlp_fwd_cuda(x2, w1, b1, w2, b2, save_residuals: bool = False):
    """Forward kernels of the MLP without the LayerNorm on ``x2`` (M, C):
    one wrapper call on the current stream, one launch at bfloat16 at the
    fused widths (``mlp_bf16_fused``; without ``save_residuals`` it
    allocates and writes nothing of (M, F)), else two (a passes through
    device memory); returns o, and with ``save_residuals`` (o, a, s), at
    x's dtype (float32, or bfloat16 with bfloat16 weights and biases)."""
    bf16 = x2.dtype == torch.bfloat16
    m, c, f = _check(x2, w1, (("x", x2, "mc"), ("w1", w1, "fc"),
                              ("b1", b1, "f"), ("w2", w2, "cf"),
                              ("b2", b2, "c")), "MLP", bf16=bf16)
    dev = x2.device
    o = torch.empty_like(x2)
    a = None
    if save_residuals or not (bf16 and mlp_bf16_fused(c, f)):
        a = torch.empty((m, f), dtype=x2.dtype, device=dev)
    s = torch.empty_like(a) if save_residuals else None
    lib = _lib()
    fwd = lib.vitta_mlp_fwd_bf16 if bf16 else lib.vitta_mlp_fwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fwd(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                   b2.data_ptr(), None if a is None else a.data_ptr(),
                   None if s is None else s.data_ptr(), o.data_ptr(), m, c, f,
                   stream)
    raise_on(code, "MLP forward kernel")
    counters.mlp_fwd += 1
    return (o, a, s) if save_residuals else o


def mlp_bwd_cuda(x2, a, s, g, w1, w2, taps=None):
    """Backward kernels of the MLP without the LayerNorm: one wrapper call,
    its launches on the current stream.  Returns (dx, dw1, db1, dw2, db2),
    allocated here with the scratch (float32: dh (M, F) and the partial
    sums; bfloat16: dhc (M, F) and the partial sums).  ``taps``, a dict, at
    bfloat16 only: the dh product also writes the float32 dh, and
    ``taps["dh"]`` and ``taps["dhc"]`` hold dh and its rounded form as the
    kernels made them, for a check.  At bfloat16 at the fused widths: the
    row pass, dw1 and dw2, one reduce (``bf16_bwd_launches``)."""
    bf16 = x2.dtype == torch.bfloat16
    m, c, f = _check(x2, w1, (("x", x2, "mc"), ("a", a, "mf"),
                              ("s", s, "mf"), ("grad of o", g, "mc"),
                              ("w1", w1, "fc"), ("w2", w2, "cf")), "MLP",
                     bf16=bf16)
    if taps is not None and not bf16:
        raise ValueError("taps are read from the bfloat16 kernels only")
    dev = x2.device
    lib = _lib()
    new = lambda *shape: torch.empty(shape, dtype=x2.dtype, device=dev)
    dx, dw1, db1, dw2, db2 = new(m, c), new(f, c), new(f), new(c, f), new(c)
    floats = (lib.vitta_mlp_bwd_bf16_scratch_floats if bf16
              else lib.vitta_mlp_bwd_scratch_floats)(m, c, f)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    ptrs = [x2.data_ptr(), a.data_ptr(), s.data_ptr(), g.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), scratch.data_ptr()]
    if bf16:
        dh = None
        if taps is not None:
            dh = taps["dh"] = torch.empty((m, f), dtype=torch.float32,
                                          device=dev)
            taps["dhc"] = scratch[:m * f // 2].view(torch.bfloat16).view(m, f)
        ptrs.append(None if dh is None else dh.data_ptr())
    bwd = lib.vitta_mlp_bwd_bf16 if bf16 else lib.vitta_mlp_bwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = bwd(*ptrs, m, c, f, stream)
    raise_on(code, "MLP backward kernel")
    counters.mlp_bwd += 1
    return dx, dw1, db1, dw2, db2


class Mlp(torch.autograd.Function):
    """The kernels as one differentiable op (the counterpart of the custom
    VJP at pallas_mlp.py:249-269).  With ``keep`` the forward has the
    kernel emit a and s and keeps (x, w1, w2, a, s); without it nothing is
    kept.  A strided cotangent is copied once, and counted."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, save_residuals, keep):
        res = mlp_fwd_cuda(x2, w1, b1, w2, b2, save_residuals or keep)
        if keep:
            ctx.save_for_backward(x2, w1, w2, *res[1:])          # a, s
        if not save_residuals:
            return res[0] if keep else res
        ctx.mark_non_differentiable(res[1], res[2])
        return res

    @staticmethod
    def backward(ctx, g, *_residual_grads):
        x2, w1, w2, a, s = ctx.saved_tensors
        return mlp_bwd_cuda(x2, a, s, contiguous_counted(g), w1, w2) \
            + (None, None)


class MlpPlain(torch.autograd.Function):
    """The bfloat16 plain forward and plain backward of the MLP without the
    LayerNorm as one differentiable op, the CPU's form at bfloat16: it
    rounds where the kernels round (``mlp_bf16_reference``,
    ``mlp_bf16_backward_reference``)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2):
        o, a, s = mlp_bf16_reference(x2, w1, b1, w2, b2, save_residuals=True)
        ctx.save_for_backward(x2, a, s, w1, w2)
        return o

    @staticmethod
    def backward(ctx, g):
        x2, a, s, w1, w2 = ctx.saved_tensors
        return mlp_bf16_backward_reference(x2, a, s, g, w1, w2)


def mlp(x, w1, b1, w2, b2, save_residuals: bool = False):
    """(fc1 -> exact GELU -> fc2)(x) over the last axis of ``x`` (..., C),
    in x's shape; with ``save_residuals`` also a and s as (M, F).  x, the
    weights and the biases all float32 or all bfloat16.

    A CPU tensor takes the plain version (at bfloat16 with the plain
    backward, ``MlpPlain``, where a gradient is wanted); a CUDA tensor takes
    the kernels (forward, and backward under autograd), which raise on any
    other dtype, a non-contiguous input, or a C or F that is not a multiple
    of 4 (8 and 16-byte aligned tensors at bfloat16)."""
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            if not save_residuals and grad_wanted(x, w1, b1, w2, b2):
                c = x.shape[-1]
                return MlpPlain.apply(x.reshape(-1, c), w1, b1, w2,
                                      b2).reshape(x.shape)
            res = mlp_bf16_reference(x, w1, b1, w2, b2, save_residuals)
        else:
            res = mlp_reference(x, w1, b1, w2, b2, save_residuals)
        if save_residuals:
            f = w1.shape[0]
            return res[0], res[1].reshape(-1, f), res[2].reshape(-1, f)
        return res
    if x.device.type != "cuda":
        raise ValueError(f"no MLP implementation for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    res = Mlp.apply(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2,
                    save_residuals, grad_wanted(x, w1, b1, w2, b2))
    if not save_residuals:
        return res.reshape(x.shape)
    return (res[0].reshape(x.shape),) + tuple(res[1:])
