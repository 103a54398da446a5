"""Projection-fused window attention, with and without the LayerNorm
prologue, forward and backward: CUDA kernels, plain versions, autograd
wrappers.

On windows x (B_, N, C), with the weights in ``nn.Linear`` layout (wqkv
(3C, C), wproj (C, C)), the dense bias (nh, N, N) and the shift mask
(nW, N, N) of 0 / -100 or None:

    qkv = x wqkv^T + bqkv                     last axis ordered (3, nh, hd)
    o_att = softmax(scale q k^T + bias[h] + mask[b mod nW]) v     per head
    out = o_att wproj^T + bproj                                -> (B_, N, C)

``window_attention_proj`` computes that; ``window_attention_ln_proj`` first
normalizes x (one-pass float32 LayerNorm, gamma and beta) and returns
``(out, y)`` with y the LayerNorm output in window layout, which the norm1
statistic tap reads and whose cotangent re-enters the backward.  They are
the counterparts of vitta_tpu/ops/pallas_attention.py:1200 and :1159.

A CPU tensor takes the plain PyTorch versions (``proj_attention_reference``
and ``ln_proj_attention_reference``, under torch's own autograd) and a CUDA
tensor the hand-written kernels in ``vitta_tpu_torch/csrc/attention_proj.cu``,
the counterparts of pallas_attention.py:724-782 and :945-1016; every matrix
product on that path is the kernels' own.  When a gradient is wanted the
forward keeps the inputs, o_att (B_, N, C), ms, the softmax row maximum
and sum (B_, N, 2nh), and qkv (B_, N, 3C), which the forward computes
anyway (and y, an output of the LayerNorm form); the backward then makes
no qkv product and no LayerNorm forward.  The JAX package keeps less
(pallas_attention.py:901-905, :1125-1130) and recomputes qkv and y: one
window's qkv lived in the TPU kernel's VMEM only.  On the card the kept qkv
costs 3C floats a token per block.  ``proj_attention_backward_reference``
and ``ln_proj_attention_backward_reference`` are the backward's plain
versions, from the same kept tensors.  A parameter that wants no gradient
gets None and its launches are skipped.  The mask has no gradient.  There
is no fallback: a CUDA tensor a kernel does not take raises.

At bfloat16 (x, the four projection weights and biases, y, qkv, o_att,
out, the cotangents and every gradient but dgamma, dbeta and dbias
bfloat16; gamma, beta, the dense bias, the mask, ms and dbias float32) the
kernels are ``vitta_attn_{proj,ln_proj}_{fwd,bwd}_bf16``, the counterparts
of the same Pallas kernels at the compute dtype, and they round where those
do (pallas_attention.py:724-782, :945-1016; VJP :910-917, :1134-1144): qkv
and out as flax's Dense at the compute dtype, the float32 product rounded
before the bfloat16 bias is added and the sum rounded again (never one
rounding of product plus bias, as ``F.linear`` at bfloat16 would); the
attention as the packed bfloat16 pair on the dense bias; g_att = g wproj
rounded once; dx = dqkv wqkv rounded once, where the LayerNorm form keeps
dy = dqkv wqkv + gy float32 for the LayerNorm backward; the weight and
bias gradients float32 sums over every row, each rounded once; dbias the
float32 sum of dl over the windows in their order.  Their products run on
the bfloat16 wgmma core (csrc/gemm_wgmma_bf16.cuh), cut as
``bf16_gemm_plan_cuda`` reports.  ``proj_attention_bf16_reference``,
``proj_attention_bf16_backward_reference`` and the ``ln_proj`` pair are
their plain versions; on the CPU a bfloat16 x runs them as one autograd
Function (``ProjAttentionPlain``, ``LnProjAttentionPlain``).

The backward's scratch (the cotangents of the attention's output and of
qkv, the partial sums) comes from torch's caching allocator inside each
wrapper, on the input's device and current stream, and is freed on return;
the allocator hands it out again only to work queued on the same stream
behind the kernels that read it.  The port runs everything on one stream.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops._launch import (LaunchCounters, check_tensor,
                                         contiguous_counted, grad_wanted,
                                         raise_on)
from vitta_tpu_torch.ops.cuda_attention import (
    _e_tap, packed_attention_backward_reference,
    packed_attention_bf16_backward_reference, packed_attention_bf16_reference,
    packed_attention_reference)
from vitta_tpu_torch.ops.cuda_ln import (layer_norm_backward_reference,
                                         layer_norm_reference)

counters = LaunchCounters("proj_fwd", "proj_bwd", "ln_proj_fwd",
                          "ln_proj_bwd")

WHAT = "projection-fused window attention"


# ------------------------------------------------------------ plain versions
def proj_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                             scale: float, nh: int,
                             save_residuals: bool = False):
    """The unfused composition on ``x`` (B_, N, C); returns out, and with
    ``save_residuals`` (out, qkv, o_att, ms)."""
    qkv = F.linear(x, wqkv, bqkv)
    if not save_residuals:
        o_att = packed_attention_reference(qkv, bias, mask, scale, nh)
        return F.linear(o_att, wproj, bproj)
    o_att, ms = packed_attention_reference(qkv, bias, mask, scale, nh, True)
    return F.linear(o_att, wproj, bproj), qkv, o_att, ms


def proj_attention_backward_reference(x, qkv, wqkv, wproj, bias, mask, o_att,
                                      ms, g, scale: float, nh: int):
    """(dx, dwqkv, dbqkv, dwproj, dbproj, dbias) for the cotangent ``g`` of
    out, written out from what the forward keeps (x, qkv, o_att, ms) as the
    kernels compute it: the products of pallas_attention.py:747-782 with
    qkv read, not recomputed."""
    c = x.shape[-1]
    g2, o2, x2 = g.reshape(-1, c), o_att.reshape(-1, c), x.reshape(-1, c)
    dwproj, dbproj = g2.t() @ o2, g2.sum(dim=0)
    g_att = g @ wproj
    dqkv, dbias = packed_attention_backward_reference(qkv, bias, mask, ms,
                                                      g_att, scale, nh)
    d2 = dqkv.reshape(-1, 3 * c)
    return dqkv @ wqkv, d2.t() @ x2, d2.sum(dim=0), dwproj, dbproj, dbias


def ln_proj_attention_reference(x, gamma, beta, eps: float, wqkv, bqkv, wproj,
                                bproj, bias, mask, scale: float, nh: int,
                                save_residuals: bool = False):
    """LayerNorm, then ``proj_attention_reference``; returns (out, y), and
    with ``save_residuals`` (out, y, qkv, o_att, ms)."""
    y = layer_norm_reference(x, gamma, beta, eps)
    res = proj_attention_reference(y, wqkv, bqkv, wproj, bproj, bias, mask,
                                   scale, nh, save_residuals)
    return (res[0], y) + tuple(res[1:]) if save_residuals else (res, y)


def ln_proj_attention_backward_reference(x, y, qkv, gamma, eps: float, wqkv,
                                         wproj, bias, mask, o_att, ms, g, gy,
                                         scale: float, nh: int):
    """(dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias) for the
    cotangents ``g`` of out and ``gy`` of y (or None), from what the forward
    keeps (x, y, qkv, o_att, ms) as the kernels compute it
    (pallas_attention.py:967-1016 with y and qkv read, not recomputed); the
    LayerNorm backward takes the row statistics from x."""
    dy, dwqkv, dbqkv, dwproj, dbproj, dbias = \
        proj_attention_backward_reference(y, qkv, wqkv, wproj, bias, mask,
                                          o_att, ms, g, scale, nh)
    if gy is not None:
        dy = dy + gy
    c = x.shape[-1]
    dx, dgamma, dbeta = layer_norm_backward_reference(
        x.reshape(-1, c), gamma, dy.reshape(-1, c), eps)
    return (dx.reshape(x.shape), dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj,
            dbias)


# ------------------------------------------------- plain versions, bfloat16
BF16 = torch.bfloat16


def dense_bf16(a, w, b):
    """flax's Dense at the compute dtype as the projection-fused kernels
    apply it to bfloat16 ``a`` (..., K) with ``w`` (N, K) and ``b`` (N):
    the float32 product of the bfloat16 values rounded to bfloat16, then
    the bfloat16 bias added and the sum rounded again
    (pallas_attention.py:732, :737)."""
    k = a.shape[-1]
    prod = (a.reshape(-1, k).float() @ w.float().t()).to(BF16)
    return (prod.float() + b.float()).to(BF16).reshape(*a.shape[:-1], -1)


def proj_attention_bf16_reference(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                  scale: float, nh: int,
                                  save_residuals: bool = False):
    """The bfloat16 forward as the kernels compute it: qkv = Dense(x),
    the packed bfloat16 attention on the dense bias, out = Dense(o_att).
    Returns out, and with ``save_residuals`` (out, qkv, o_att, ms)."""
    qkv = dense_bf16(x, wqkv, bqkv)
    o_att, ms = packed_attention_bf16_reference(qkv, bias, mask, scale, nh,
                                                save_ms=True)
    out = dense_bf16(o_att, wproj, bproj)
    return (out, qkv, o_att, ms) if save_residuals else out


def _proj_bf16_backward(y, qkv, wqkv, wproj, bias, mask, o_att, ms, g,
                        scale: float, nh: int):
    """(dqkv wqkv float32, dwqkv, dbqkv, dwproj, dbproj, dbias) at
    bfloat16 from the qkv product's input ``y`` (x without the LayerNorm):
    g_att = g wproj rounded once, the bfloat16 attention backward, the
    weight and bias gradients float32 sums rounded once."""
    c = y.shape[-1]
    g2 = g.reshape(-1, c).float()
    dwproj = (g2.t() @ o_att.reshape(-1, c).float()).to(BF16)
    dbproj = g2.sum(dim=0).to(BF16)
    g_att = (g.float() @ wproj.float()).to(BF16)
    dqkv, dbias = packed_attention_bf16_backward_reference(
        qkv, bias, mask, ms, g_att, scale, nh)
    d2 = dqkv.reshape(-1, 3 * c).float()
    dy = (d2 @ wqkv.float()).reshape(y.shape)
    return (dy, (d2.t() @ y.reshape(-1, c).float()).to(BF16),
            d2.sum(dim=0).to(BF16), dwproj, dbproj, dbias)


def proj_attention_bf16_backward_reference(x, qkv, wqkv, wproj, bias, mask,
                                           o_att, ms, g, scale: float,
                                           nh: int):
    """(dx, dwqkv, dbqkv, dwproj, dbproj, dbias) at bfloat16 for the
    cotangent ``g`` of out, from what the forward keeps, as the kernels
    compute them (pallas_attention.py:747-782, VJP :910-917): dx =
    bfloat16(dqkv wqkv); dbias float32."""
    dy, *grads = _proj_bf16_backward(x, qkv, wqkv, wproj, bias, mask, o_att,
                                     ms, g, scale, nh)
    return (dy.to(BF16), *grads)


def ln_proj_attention_bf16_reference(x, gamma, beta, eps: float, wqkv, bqkv,
                                     wproj, bproj, bias, mask, scale: float,
                                     nh: int, save_residuals: bool = False):
    """The bfloat16 LayerNorm (y rounded once), then
    ``proj_attention_bf16_reference`` on y; returns (out, y), and with
    ``save_residuals`` (out, y, qkv, o_att, ms)."""
    y = layer_norm_reference(x, gamma, beta, eps)
    res = proj_attention_bf16_reference(y, wqkv, bqkv, wproj, bproj, bias,
                                        mask, scale, nh, save_residuals)
    return (res[0], y) + tuple(res[1:]) if save_residuals else (res, y)


def ln_proj_attention_bf16_backward_reference(x, y, qkv, gamma, eps: float,
                                              wqkv, wproj, bias, mask, o_att,
                                              ms, g, gy, scale: float,
                                              nh: int):
    """(dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias) at bfloat16
    for the cotangents ``g`` of out and ``gy`` of y (or None), as the
    kernels compute them (pallas_attention.py:967-1016, VJP :1134-1144):
    dy = dqkv wqkv + gy in float32, never rounded, into the LayerNorm
    backward at x; dx bfloat16, dgamma, dbeta and dbias float32."""
    dy, *grads = _proj_bf16_backward(y, qkv, wqkv, wproj, bias, mask, o_att,
                                     ms, g, scale, nh)
    if gy is not None:
        dy = dy + gy.float()
    c = x.shape[-1]
    dx, dgamma, dbeta = layer_norm_backward_reference(
        x.reshape(-1, c), gamma, dy.reshape(-1, c), eps)
    return (dx.to(BF16).reshape(x.shape), dgamma, dbeta, *grads)


# ------------------------------------------------------------------ kernels
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("attention_proj")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vitta_attn_proj_fwd.argtypes = [p] * 11 + [i] * 5 + [f, p]
        lib.vitta_attn_ln_proj_fwd.argtypes = [p] * 14 + [i] * 5 + [f, f, p]
        lib.vitta_attn_proj_bwd.argtypes = [p] * 16 + [i] * 5 + [f, p]
        lib.vitta_attn_ln_proj_bwd.argtypes = [p] * 20 + [i] * 5 + [f, f, p]
        for fn in (lib.vitta_attn_proj_fwd, lib.vitta_attn_ln_proj_fwd,
                   lib.vitta_attn_proj_bwd, lib.vitta_attn_ln_proj_bwd):
            fn.restype = i
        lib.vitta_attn_proj_bwd_scratch_floats.argtypes = [i] * 5
        lib.vitta_attn_proj_bwd_scratch_floats.restype = ctypes.c_longlong
        # the float32 entries' arguments and e_tap before the stream
        for name in ("proj_fwd", "ln_proj_fwd", "proj_bwd", "ln_proj_bwd"):
            f32_fn = getattr(lib, f"vitta_attn_{name}")
            fn = getattr(lib, f"vitta_attn_{name}_bf16")
            fn.argtypes = f32_fn.argtypes[:-1] + [p, p]
            fn.restype = i
        lib.vitta_attn_proj_bwd_bf16_scratch_floats.argtypes = [i] * 5
        lib.vitta_attn_proj_bwd_bf16_scratch_floats.restype = \
            ctypes.c_longlong
        lib.vitta_attn_proj_bwd_bf16_plan.argtypes = [
            i] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.vitta_attn_proj_bwd_bf16_plan.restype = None
        lib.vitta_attn_proj_bf16_plan.argtypes = [
            i, i, ctypes.POINTER(ctypes.c_int)]
        lib.vitta_attn_proj_bf16_plan.restype = None
        lib.vitta_attn_proj_bwd_bf16_launches.argtypes = [i] * 5
        lib.vitta_attn_proj_bwd_bf16_launches.restype = i
        _LIB = lib
    return _LIB


# The six products of the bfloat16 chains, in the order the library's plan
# gives them, each C (M, N) over K for M rows of width C: qkv = y wqkv^T,
# out = o_att wproj^T, g_att = g wproj, dx (dy under the LayerNorm) =
# dqkv wqkv, dwqkv = dqkv^T y, dwproj = g^T o_att.
BF16_PRODUCTS = ("qkv", "out", "g_att", "dx", "dwqkv", "dwproj")


def bf16_product_dims(m: int, c: int):
    """{product: (M, N, K)} of the six bfloat16 products."""
    return {"qkv": (m, 3 * c, c), "out": (m, c, c), "g_att": (m, c, c),
            "dx": (m, c, 3 * c), "dwqkv": (3 * c, c, m),
            "dwproj": (c, c, m)}


def bf16_gemm_plan(m: int, c: int, sms: int = 132):
    """How the bfloat16 core cuts the six products on a card of ``sms``
    SMs, by the rules of the LayerNorm-MLP's (``cuda_mlp.wgmma_plan``):
    {product: {bm, bn, splits, kchunk, grid, smem}}, the two weight
    gradients' chunks of K cut for the tiles of both, which share one
    launch and its grid."""
    from vitta_tpu_torch.ops.cuda_mlp import wgmma_plan
    return wgmma_plan(bf16_product_dims(m, c), ("dwqkv", "dwproj"), sms)


def bf16_gemm_plan_cuda(m: int, c: int):
    """The library's own plan of the six bfloat16 products on this card
    (the keys of ``bf16_gemm_plan``)."""
    from vitta_tpu_torch.ops.cuda_mlp import BF16_PLAN_KEYS
    k = len(BF16_PLAN_KEYS)
    out = (ctypes.c_int * (k * len(BF16_PRODUCTS)))()
    _lib().vitta_attn_proj_bf16_plan(m, c, out)
    return {name: dict(zip(BF16_PLAN_KEYS, out[k * i:k * i + k]))
            for i, name in enumerate(BF16_PRODUCTS)}


def bf16_bwd_launches_cuda(b_: int, n: int, nh: int, hd: int,
                           with_ln: bool) -> int:
    """The library's count of the launches of one bfloat16 backward call
    that wants every gradient, on this card: g_att, the attention backward
    (2, or 3 where blocks share a problem), dx or dy, both weight gradients
    in one launch, the column partials of g and dqkv, the LayerNorm
    backward's one under ``with_ln``, one reduce_sums."""
    return _lib().vitta_attn_proj_bwd_bf16_launches(b_, n, nh, hd,
                                                    int(with_ln))


# the largest window and head size of the attention kernels
# (csrc/attention_kernels.cuh) and the row alignment of gemm_tiles
MAX_TOKENS, MAX_HEAD_DIM = 416, 32
# the tensors that stay float32 at bfloat16
_F32_NAMES = ("gamma", "beta", "bias", "ms")


def _check(x, nh: int, mask, named):
    """Raise on anything the kernels do not take; ``named`` lists (name,
    tensor, shape as a string over b, n, c, t (3c), h (nh), m (2nh)).  x
    float32, or bfloat16 with every tensor but those of ``_F32_NAMES`` and
    the mask bfloat16, each on a 16-byte boundary, and hd a multiple of 8.
    Returns (B_, N, C, hd, nW)."""
    if x.dim() != 3 or x.shape[2] % nh != 0:
        raise ValueError(f"x must be (B_, N, nh*hd) with nh={nh}, got shape "
                         f"{tuple(x.shape)}")
    b_, n, c = x.shape
    hd = c // nh
    bf16 = x.dtype == BF16
    dims = {"b": b_, "n": n, "c": c, "t": 3 * c, "h": nh, "m": 2 * nh}
    for name, ten, shape in named:
        dtype = BF16 if bf16 and name not in _F32_NAMES else torch.float32
        check_tensor(WHAT, name, ten, tuple(dims[d] for d in shape), x.device,
                     dtypes=(dtype,))
        if bf16 and ten.data_ptr() % 16:
            raise ValueError(f"the bfloat16 {WHAT} kernels take tensors on "
                             f"16-byte boundaries; {name} lies "
                             f"{ten.data_ptr() % 16} bytes past one")
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check_tensor(WHAT, "mask", mask, (nw, n, n), x.device)
        if b_ % nw != 0:
            raise ValueError(f"{b_} windows are not a multiple of the "
                             f"mask's {nw}")
    if b_ == 0 or n == 0:
        raise ValueError("x has no rows")
    unit = 8 if bf16 else 4
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM or c % 4 != 0 or (
            bf16 and hd % unit != 0):
        raise ValueError(
            f"the {WHAT} kernels take N <= {MAX_TOKENS}, hd <= "
            f"{MAX_HEAD_DIM} and C a multiple of 4 (at bfloat16 hd a "
            f"multiple of 8); got N={n}, hd={hd}, C={c}")
    return b_, n, c, hd, nw


def _ptr(t):
    return None if t is None else t.data_ptr()


_FWD_NAMED = (("wqkv", "tc"), ("bqkv", "t"), ("wproj", "cc"), ("bproj", "c"),
              ("bias", "hnn"))


def _fwd_cuda(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh,
              save_residuals, taps=None):
    """Both forward entry points at x's dtype; ``ln`` is (gamma, beta, eps)
    or None.  Returns (out, y or None, qkv, o_att, ms or None)."""
    named = [("x", x, "bnc")] + [
        (name, ten, shape) for (name, shape), ten in
        zip(_FWD_NAMED, (wqkv, bqkv, wproj, bproj, bias))]
    if ln is not None:
        named += [("gamma", ln[0], "c"), ("beta", ln[1], "c")]
    b_, n, c, hd, nw = _check(x, nh, mask, named)
    dev = x.device
    lib = _lib()
    bf16 = x.dtype == BF16
    new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=dev)
    out, qkv, o_att = new(b_, n, c), new(b_, n, 3 * c), new(b_, n, c)
    ms = torch.empty((b_, n, 2 * nh), dtype=torch.float32,
                     device=dev) if save_residuals else None
    # the bfloat16 entries take e_tap before the stream
    tail = (_ptr(_e_tap(taps, x, b_, n, nh)),) if bf16 else ()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if ln is None:
            y = None
            fwd = lib.vitta_attn_proj_fwd_bf16 if bf16 \
                else lib.vitta_attn_proj_fwd
            code = fwd(
                x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(),
                _ptr(mask), qkv.data_ptr(), o_att.data_ptr(), _ptr(ms),
                out.data_ptr(), b_, n, nh, hd, nw, float(scale), *tail,
                stream)
        else:
            y = new(b_, n, c)
            fwd = lib.vitta_attn_ln_proj_fwd_bf16 if bf16 \
                else lib.vitta_attn_ln_proj_fwd
            code = fwd(
                x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
                wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
                bproj.data_ptr(), bias.data_ptr(), _ptr(mask), y.data_ptr(),
                qkv.data_ptr(), o_att.data_ptr(), _ptr(ms), out.data_ptr(),
                b_, n, nh, hd, nw, float(ln[2]), float(scale), *tail, stream)
    raise_on(code, f"{WHAT} forward kernel")
    return out, y, qkv, o_att, ms


def attn_proj_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask, scale: float,
                  nh: int, save_residuals: bool = False, taps=None):
    """Forward kernels on ``x`` (B_, N, C): one wrapper call, three
    launches on the current stream; returns out, and with
    ``save_residuals`` (out, qkv, o_att, ms), what the backward reads.
    ``taps``, a dict, at bfloat16 only: the attention kernel's instance
    that also writes bfloat16(e) runs, and ``taps["e"]`` (B_, nh, N, N)
    holds it, for a check."""
    out, _y, qkv, o_att, ms = _fwd_cuda(x, None, wqkv, bqkv, wproj, bproj,
                                        bias, mask, scale, nh,
                                        save_residuals, taps)
    counters.proj_fwd += 1
    return (out, qkv, o_att, ms) if save_residuals else out


def attn_ln_proj_fwd(x, gamma, beta, eps: float, wqkv, bqkv, wproj, bproj,
                     bias, mask, scale: float, nh: int,
                     save_residuals: bool = False, taps=None):
    """Forward kernels with the LayerNorm in front: four launches; returns
    (out, y), and with ``save_residuals`` (out, y, qkv, o_att, ms);
    ``taps`` as for ``attn_proj_fwd``."""
    out, y, qkv, o_att, ms = _fwd_cuda(x, (gamma, beta, eps), wqkv, bqkv,
                                       wproj, bproj, bias, mask, scale, nh,
                                       save_residuals, taps)
    counters.ln_proj_fwd += 1
    return (out, y, qkv, o_att, ms) if save_residuals else (out, y)


# which of (dwqkv, dbqkv, dwproj, dbproj, dbias) a backward computes
ALL_GRADS = (True,) * 5


def bf16_bwd_scratch_views(scratch, b_: int, n: int, nh: int, hd: int,
                           with_ln: bool):
    """{g_att, dqkv (bfloat16), dy (float32, under the LayerNorm), dl
    (float32 (B_, nh, N, N))}: the bfloat16 backward's intermediates in its
    ``scratch``, at the offsets the library gives
    (``vitta_attn_proj_bwd_bf16_plan``), for a check that holds each step
    to its plain version on the kernel's own inputs."""
    offsets = (ctypes.c_longlong * 4)()
    _lib().vitta_attn_proj_bwd_bf16_plan(b_, n, nh, hd, int(with_ln),
                                         offsets)
    c, m = nh * hd, b_ * n
    at = list(offsets)
    views = {
        "g_att": scratch[at[0]:at[0] + m * c // 2].view(BF16).view(b_, n, c),
        "dqkv": scratch[at[1]:at[1] + 3 * m * c // 2].view(BF16).view(
            b_, n, 3 * c),
        "dl": scratch[at[3]:at[3] + b_ * nh * n * n].view(b_, nh, n, n)}
    if with_ln:
        views["dy"] = scratch[at[2]:at[2] + m * c].view(b_, n, c)
    return views


def _bwd_cuda(x, y, qkv, ln, wqkv, wproj, bias, mask, o_att, ms, g, gy,
              scale, nh, want, taps=None):
    """Both backward entry points at x's dtype; ``ln`` is (gamma, eps) or
    None, and then y is None (the qkv projection's input is x).  At
    bfloat16 dbias is always computed (the kernel sums dl into it) and
    dropped where ``want`` says so."""
    named = [("x", x, "bnc"), ("qkv", qkv, "bnt"), ("wqkv", wqkv, "tc"),
             ("wproj", wproj, "cc"), ("bias", bias, "hnn"),
             ("o_att", o_att, "bnc"), ("ms", ms, "bnm"),
             ("grad of out", g, "bnc")]
    if ln is not None:
        named += [("y", y, "bnc"), ("gamma", ln[0], "c")]
    if gy is not None:
        named.append(("grad of y", gy, "bnc"))
    b_, n, c, hd, nw = _check(x, nh, mask, named)
    dev = x.device
    lib = _lib()
    bf16 = x.dtype == BF16
    new = lambda dtype, *shape: torch.empty(shape, dtype=dtype, device=dev)
    dx = new(x.dtype, b_, n, c)
    shapes = ((3 * c, c), (3 * c,), (c, c), (c,), (nh, n, n))
    grads = [new(torch.float32 if i == 4 else x.dtype, *s)
             if w or (bf16 and i == 4) else None
             for i, (s, w) in enumerate(zip(shapes, want))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        # sized for this card: the products' chunks and a problem's blocks
        # depend on its SM count
        floats = (lib.vitta_attn_proj_bwd_bf16_scratch_floats if bf16
                  else lib.vitta_attn_proj_bwd_scratch_floats)(
                      b_, n, nh, hd, int(ln is not None))
        scratch = new(torch.float32, floats)
        tail = (_ptr(_e_tap(taps, x, b_, n, nh)),) if bf16 else ()
        if ln is None:
            dgb = None
            bwd = lib.vitta_attn_proj_bwd_bf16 if bf16 \
                else lib.vitta_attn_proj_bwd
            code = bwd(
                x.data_ptr(), qkv.data_ptr(), wqkv.data_ptr(),
                wproj.data_ptr(), bias.data_ptr(), _ptr(mask),
                o_att.data_ptr(), ms.data_ptr(), g.data_ptr(), dx.data_ptr(),
                *(_ptr(t) for t in grads), scratch.data_ptr(), b_, n, nh, hd,
                nw, float(scale), *tail, stream)
        else:
            dgb = new(torch.float32, 2, c)
            bwd = lib.vitta_attn_ln_proj_bwd_bf16 if bf16 \
                else lib.vitta_attn_ln_proj_bwd
            code = bwd(
                x.data_ptr(), y.data_ptr(), qkv.data_ptr(), ln[0].data_ptr(),
                wqkv.data_ptr(), wproj.data_ptr(), bias.data_ptr(),
                _ptr(mask), o_att.data_ptr(), ms.data_ptr(), g.data_ptr(),
                _ptr(gy), dx.data_ptr(), dgb.data_ptr(),
                *(_ptr(t) for t in grads), scratch.data_ptr(), b_, n, nh, hd,
                nw, float(ln[1]), float(scale), *tail, stream)
    raise_on(code, f"{WHAT} backward kernel")
    if taps is not None:
        taps.update(bf16_bwd_scratch_views(scratch, b_, n, nh, hd,
                                           ln is not None))
    if not want[4]:
        grads[4] = None
    return dx, dgb, grads


def attn_proj_bwd(x, qkv, wqkv, wproj, bias, mask, o_att, ms, g,
                  scale: float, nh: int, want=ALL_GRADS, taps=None):
    """Backward kernels from what the forward kept (x, qkv, o_att, ms): one
    wrapper call, its launches on the current stream.  Returns (dx, dwqkv,
    dbqkv, dwproj, dbproj, dbias), allocated here with the scratch; an
    entry whose ``want`` is False is None and, but for the bfloat16
    dbias, is not computed.  ``taps``, a dict, at bfloat16 only: ``e`` as
    ``attn_proj_fwd`` fills it, and the scratch's g_att, dqkv and dl
    (``bf16_bwd_scratch_views``)."""
    dx, _dgb, grads = _bwd_cuda(x, None, qkv, None, wqkv, wproj, bias, mask,
                                o_att, ms, g, None, scale, nh, want, taps)
    counters.proj_bwd += 1
    return (dx, *grads)


def attn_ln_proj_bwd(x, y, qkv, gamma, eps: float, wqkv, wproj, bias, mask,
                     o_att, ms, g, gy, scale: float, nh: int,
                     want=ALL_GRADS, taps=None):
    """Backward kernels through the LayerNorm, from what the forward kept
    (x, y, qkv, o_att, ms); ``gy`` may be None (no cotangent on y).
    Returns (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias);
    ``taps`` as for ``attn_proj_bwd``, with dy too."""
    dx, dgb, grads = _bwd_cuda(x, y, qkv, (gamma, eps), wqkv, wproj, bias,
                               mask, o_att, ms, g, gy, scale, nh, want, taps)
    counters.ln_proj_bwd += 1
    return (dx, dgb[0], dgb[1], *grads)


# ----------------------------------------------------------------- autograd
class ProjWindowAttention(torch.autograd.Function):
    """The kernels as one differentiable op (the counterpart of the custom
    VJP at pallas_attention.py:895-919).  With ``keep`` the forward has
    the kernel emit ms and keeps (x, wqkv, wproj, bias, mask, qkv, o_att,
    ms); without it nothing is kept.  A strided cotangent is copied once,
    and counted."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh,
                keep):
        ctx.scale, ctx.nh = scale, nh
        if not keep:
            return attn_proj_fwd(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                 scale, nh)
        out, qkv, o_att, ms = attn_proj_fwd(x, wqkv, bqkv, wproj, bproj,
                                            bias, mask, scale, nh, True)
        ctx.save_for_backward(x, wqkv, wproj, bias, mask, qkv, o_att, ms)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, wproj, bias, mask, qkv, o_att, ms = ctx.saved_tensors
        need = ctx.needs_input_grad
        want = (need[1], need[2], need[3], need[4], need[5])
        dx, dwqkv, dbqkv, dwproj, dbproj, dbias = attn_proj_bwd(
            x, qkv, wqkv, wproj, bias, mask, o_att, ms,
            contiguous_counted(g), ctx.scale, ctx.nh, want)
        return (dx if need[0] else None, dwqkv, dbqkv, dwproj, dbproj, dbias,
                None, None, None, None)


class LnProjWindowAttention(torch.autograd.Function):
    """The LayerNorm form (the counterpart of the custom VJP at
    pallas_attention.py:1117-1146); with ``keep`` it also keeps y, its own
    output.  An output without a cotangent arrives as None, not as
    zeros."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                eps, scale, nh, keep):
        ctx.eps, ctx.scale, ctx.nh = eps, scale, nh
        ctx.set_materialize_grads(False)
        if not keep:
            return attn_ln_proj_fwd(x, gamma, beta, eps, wqkv, bqkv, wproj,
                                    bproj, bias, mask, scale, nh)
        out, y, qkv, o_att, ms = attn_ln_proj_fwd(
            x, gamma, beta, eps, wqkv, bqkv, wproj, bproj, bias, mask, scale,
            nh, True)
        ctx.save_for_backward(x, y, qkv, gamma, wqkv, wproj, bias, mask,
                              o_att, ms)
        return out, y

    @staticmethod
    def backward(ctx, g, gy):
        (x, y, qkv, gamma, wqkv, wproj, bias, mask, o_att,
         ms) = ctx.saved_tensors
        need = ctx.needs_input_grad
        want = (need[3], need[4], need[5], need[6], need[7])
        g = torch.zeros_like(x) if g is None else contiguous_counted(g)
        if gy is not None:
            gy = contiguous_counted(gy)
        (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj,
         dbias) = attn_ln_proj_bwd(x, y, qkv, gamma, ctx.eps, wqkv, wproj,
                                   bias, mask, o_att, ms, g, gy, ctx.scale,
                                   ctx.nh, want)
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, dwqkv, dbqkv, dwproj, dbproj,
                dbias, None, None, None, None, None)


class ProjAttentionPlain(torch.autograd.Function):
    """The bfloat16 plain forward and plain backward as one differentiable
    op, the CPU's form at bfloat16: it rounds where the kernels round."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh):
        ctx.scale, ctx.nh = scale, nh
        out, qkv, o_att, ms = proj_attention_bf16_reference(
            x, wqkv, bqkv, wproj, bproj, bias, mask, scale, nh, True)
        ctx.save_for_backward(x, wqkv, wproj, bias, mask, qkv, o_att, ms)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wqkv, wproj, bias, mask, qkv, o_att, ms = ctx.saved_tensors
        return proj_attention_bf16_backward_reference(
            x, qkv, wqkv, wproj, bias, mask, o_att, ms, g, ctx.scale,
            ctx.nh) + (None, None, None, None)


class LnProjAttentionPlain(torch.autograd.Function):
    """The LayerNorm form of ``ProjAttentionPlain``; an output without a
    cotangent arrives as None."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                eps, scale, nh):
        ctx.eps, ctx.scale, ctx.nh = eps, scale, nh
        ctx.set_materialize_grads(False)
        out, y, qkv, o_att, ms = ln_proj_attention_bf16_reference(
            x, gamma, beta, eps, wqkv, bqkv, wproj, bproj, bias, mask, scale,
            nh, True)
        ctx.save_for_backward(x, y, qkv, gamma, wqkv, wproj, bias, mask,
                              o_att, ms)
        return out, y

    @staticmethod
    def backward(ctx, g, gy):
        (x, y, qkv, gamma, wqkv, wproj, bias, mask, o_att,
         ms) = ctx.saved_tensors
        g = torch.zeros_like(x) if g is None else g
        (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj,
         dbias) = ln_proj_attention_bf16_backward_reference(
             x, y, qkv, gamma, ctx.eps, wqkv, wproj, bias, mask, o_att, ms,
             g, gy, ctx.scale, ctx.nh)
        return (dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias,
                None, None, None, None)


def _device_kind(x) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {WHAT} for device {x.device}")
    return kind


def window_attention_proj(x, wqkv, bqkv, wproj, bproj, bias, mask,
                          scale: float, nh: int):
    """qkv projection + window attention + output projection on windows
    ``x`` (B_, N, C) -> (B_, N, C).

    wqkv (3C, C), bqkv (3C), wproj (C, C), bproj (C); bias dense
    (nh, N, N); mask (nW, N, N) of 0 / -100 or None.  x and the four
    projection tensors float32, or all bfloat16; the bias and mask
    float32.  A CPU tensor takes the plain version (at bfloat16 the
    bfloat16 plain versions, forward and backward, ``ProjAttentionPlain``);
    a CUDA tensor takes the kernels (forward, and backward under autograd),
    which raise on any other dtype, a non-contiguous input, N > 416, hd >
    32, a C that is no multiple of 4, and at bfloat16 an hd that is no
    multiple of 8 or a tensor off a 16-byte boundary."""
    if _device_kind(x) == "cpu":
        if x.dtype != BF16:
            return proj_attention_reference(x, wqkv, bqkv, wproj, bproj,
                                            bias, mask, scale, nh)
        if grad_wanted(x, wqkv, bqkv, wproj, bproj, bias):
            return ProjAttentionPlain.apply(x, wqkv, bqkv, wproj, bproj,
                                            bias, mask, float(scale), nh)
        return proj_attention_bf16_reference(x, wqkv, bqkv, wproj, bproj,
                                             bias, mask, scale, nh)
    return ProjWindowAttention.apply(
        x, wqkv, bqkv, wproj, bproj, bias, mask, float(scale), nh,
        grad_wanted(x, wqkv, bqkv, wproj, bproj, bias))


def window_attention_ln_proj(x, gamma, beta, eps: float, wqkv, bqkv, wproj,
                             bproj, bias, mask, scale: float, nh: int):
    """``window_attention_proj`` on LayerNorm(x) over the last axis;
    returns ``(out, y)`` with y the LayerNorm output (B_, N, C).  Devices,
    dtypes (gamma and beta float32) and limits as for
    ``window_attention_proj``; at bfloat16 the CPU takes
    ``LnProjAttentionPlain``."""
    if _device_kind(x) == "cpu":
        if x.dtype != BF16:
            return ln_proj_attention_reference(x, gamma, beta, eps, wqkv,
                                               bqkv, wproj, bproj, bias, mask,
                                               scale, nh)
        if grad_wanted(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias):
            return LnProjAttentionPlain.apply(
                x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                float(eps), float(scale), nh)
        return ln_proj_attention_bf16_reference(x, gamma, beta, eps, wqkv,
                                                bqkv, wproj, bproj, bias,
                                                mask, scale, nh)
    return LnProjWindowAttention.apply(
        x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask, float(eps),
        float(scale), nh,
        grad_wanted(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias))
