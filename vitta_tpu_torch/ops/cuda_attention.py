"""Packed window attention forward: CUDA kernel, plain version, wrapper.

Per window b and head h, on the packed qkv projection output (B_, N, 3C)
whose last axis is ordered (3, nh, hd):

    out = softmax(scale * q k^T + bias[h] + mask[b mod nW]) v   -> (B_, N, C)

``window_attention_packed`` sends a CPU tensor to the plain PyTorch version
(``attention_reference`` on the unpacked views, the counterpart of
vitta_tpu/ops/pallas_attention.py:42) and a CUDA tensor to the
hand-written kernel in ``vitta_tpu_torch/csrc/attention.cu``, the
counterpart of pallas_attention.py:403-454.  The bias is the dense
(nh, N, N) tensor or its Toeplitz slices (nh, 2wd-1, hw, hw)
(ops/cuda_bias.py); the kernel reads either.  With ``save_ms`` the softmax
row maximum and sum (B_, N, 2nh) come back too, as a backward wants them
(pallas_attention.py:442).  There is no fallback: a CUDA tensor the kernel
does not take raises, and so does a backward pass on the card, whose
kernel (pallas_attention.py:517) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, backward_not_ported,
                                         check_tensor, raise_on)
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference

counters = LaunchCounters("fwd")


def attention_reference(q, k, v, bias, mask, scale: float):
    """The unfused model math (swin_transformer.py:138-169).

    q, k, v: (B_, N, nh, hd); bias (nh, N, N); mask (nW, N, N) or None;
    returns (B_, N, nh, hd)."""
    b_, n, nh, _ = q.shape
    attn = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    attn = attn + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
        attn = attn.reshape(b_, nh, n, n)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _dense(bias):
    if bias.dim() == 4:
        return expand_bias_reference(bias, (bias.shape[1] + 1) // 2)
    return bias


def packed_attention_reference(qkv, bias, mask, scale: float, nh: int,
                               save_ms: bool = False):
    """``attention_reference`` on the views of the packed tensor; with
    ``save_ms`` also the logits' row maximum and the sum of
    exp(logit - maximum), interleaved per head as (B_, N, 2nh)."""
    b_, n, c3 = qkv.shape
    c = c3 // 3
    q5 = qkv.reshape(b_, n, 3, nh, c // nh)
    bias = _dense(bias)
    out = attention_reference(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2], bias,
                              mask, scale).reshape(b_, n, c)
    if not save_ms:
        return out
    logits = torch.einsum("bqhd,bkhd->bhqk", q5[:, :, 0] * scale,
                          q5[:, :, 1]) + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(b_ // nw, nw, nh, n, n)
                  + mask[None, :, None]).reshape(b_, nh, n, n)
    m = logits.max(dim=-1).values                               # (B_, nh, N)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    ms = torch.stack([m, s], dim=-1).permute(0, 2, 1, 3)        # (B_, N, nh, 2)
    return out, ms.reshape(b_, n, 2 * nh).contiguous()


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vitta_attn_packed_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                              i, i, ctypes.c_float, p]
        lib.vitta_attn_packed_fwd.restype = i
        lib.vitta_attn_max_tokens.restype = i
        lib.vitta_attn_max_head_dim.restype = i
        _LIB = lib
    return _LIB


def attn_packed_fwd_cuda(qkv, bias, mask, scale: float, nh: int,
                         save_ms: bool = False):
    """Forward kernel: one launch; returns out (B_, N, C), and ms
    (B_, N, 2nh) with ``save_ms``."""
    if qkv.dim() != 3 or qkv.shape[2] % (3 * nh) != 0:
        raise ValueError(f"qkv must be (B_, N, 3*nh*hd) with nh={nh}, got "
                         f"shape {tuple(qkv.shape)}")
    b_, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    dev = qkv.device
    check_tensor("window attention", "qkv", qkv, (b_, n, c3), dev)
    compact = bias.dim() == 4
    wd = hw = 0
    if compact:
        wd, hw = (bias.shape[1] + 1) // 2, bias.shape[-1]
        check_tensor("window attention", "bias", bias,
                     (nh, 2 * wd - 1, hw, hw), dev)
        if wd * hw != n:
            raise ValueError(f"compact bias of a {wd}x{hw}-token window for "
                             f"N={n}")
    else:
        check_tensor("window attention", "bias", bias, (nh, n, n), dev)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        check_tensor("window attention", "mask", mask, (nw, n, n), dev)
        if b_ % nw != 0:
            raise ValueError(f"{b_} windows are not a multiple of the "
                             f"mask's {nw}")
    lib = _lib()
    if n > lib.vitta_attn_max_tokens() or hd > lib.vitta_attn_max_head_dim():
        raise ValueError(
            f"the window attention kernel takes N <= "
            f"{lib.vitta_attn_max_tokens()} and hd <= "
            f"{lib.vitta_attn_max_head_dim()}; got N={n}, hd={hd}")
    out = torch.empty((b_, n, c), dtype=torch.float32, device=dev)
    ms = torch.empty((b_, n, 2 * nh), dtype=torch.float32,
                     device=dev) if save_ms else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.vitta_attn_packed_fwd(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if ms is None else ms.data_ptr(), b_, n, nh, hd, nw,
            int(compact), wd, hw, float(scale), stream)
    raise_on(code, "window attention forward kernel")
    counters.fwd += 1
    return (out, ms) if save_ms else out


class PackedWindowAttention(torch.autograd.Function):
    """The forward kernel as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, nh, save_ms):
        res = attn_packed_fwd_cuda(qkv, bias, mask, scale, nh, save_ms)
        if save_ms:
            ctx.mark_non_differentiable(res[1])
        return res

    @staticmethod
    def backward(ctx, *grads):
        backward_not_ported("packed window attention", 15)


def window_attention_packed(qkv, bias, mask, scale: float, nh: int,
                            save_ms: bool = False):
    """Window attention on packed ``qkv`` (B_, N, 3C) -> (B_, N, C), the
    input layout of the output projection; ``(out, ms)`` with ``save_ms``.

    bias: dense (nh, N, N) or compact (nh, 2wd-1, hw, hw); mask (nW, N, N)
    of 0 / -100 or None.  A CPU tensor takes the plain version; a CUDA
    tensor takes the kernel, which raises on any dtype other than float32,
    a non-contiguous input, N > 416 or hd > 32."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, bias, mask, scale, nh, save_ms)
    if qkv.device.type != "cuda":
        raise ValueError(f"no window attention for device {qkv.device}")
    return PackedWindowAttention.apply(qkv, bias, mask, float(scale), nh,
                                       save_ms)
