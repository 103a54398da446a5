"""How the bfloat16 Video Swin kernels (LayerNorm, LayerNorm-MLP, MLP,
packed attention, attention per (head, window), the projection-fused
attention with and without the LayerNorm) are held to their plain versions
on the card; shared by chip_smoke.py and tests/test_torch_cuda.py.

A bfloat16 output of a kernel and of its plain version round float32 values
that their float32 sums reach in other orders, so a value may round one ulp
apart: every output is held within one bfloat16 ulp of the plain version's
(``assert_bf16_within``), or a floor of its tensor's largest magnitude,
2^-20, where a value near 0 is the difference of larger float32 terms.

An output made from an intermediate that the op rounds inside (the
LayerNorm-MLP's a before o, dh before dy and dw1; the attention's e before
e v and dv, dl before dq and dk) inherits that intermediate's one-ulp
differences, each moving it by up to a bfloat16 ulp of one term of its sum.
So each output is held, to one ulp everywhere, to its plain version
computed from the kernel's own rounded intermediates, and each intermediate
to its plain value: the LayerNorm-MLP's a is an output, and dh, its
rounded form and dy lie in the backward's scratch (``ln_mlp_fwd_stages``,
``ln_mlp_bwd_stages``); the MLP's a is an output, and its backward hands
out dh and dhc on request (``mlp_fwd_stages``, ``mlp_bwd_stages``); the
attention kernels' instances that also write bfloat16(e), and the
backward's dl in its scratch, give the attention's
(``packed_attention_bf16_fwd_stage``, ``packed_attention_bf16_bwd_stages``,
``packed_attention_bf16_intermediates``, and the ``heads_attention_bf16_``
ones of the same names per (head, window)); the projection-fused
attention's qkv and o_att are outputs of its forward, and its backward
hands out g_att, dqkv, dl and, under the LayerNorm, dy from its scratch
(``proj_fwd_stages``, ``proj_bwd_stages``; its attention steps are the
packed ones', on the kernel's own qkv and g_att).

The projection-fused attention's qkv and out are flax's Dense at
bfloat16: the float32 product rounded, then the bfloat16 bias added and the
sum rounded again.  The kernel's rounded product is not handed out, and one
ulp of a product moves the sum by many ulps of the sum where the bias
cancels most of the product; so ``assert_dense_within`` holds every value
between the Dense sums of the plain product's bfloat16 neighbours (the
rounding is monotone, so any product within one ulp lands there) and at
most ``DENSE_APART`` (1e-3) of the values apart from the plain version:
one rounding of product plus bias sets a few percent apart.

End to end, against the plain version on its own intermediates, the
attention's out and dqkv are held by ``assert_bf16_mostly_within``: at most
``BEYOND_SHARE`` (1e-4) of the values beyond one ulp or 2^-12 of the
tensor's largest magnitude, and those within ``2^-7`` (one bfloat16 ulp
relative to a value, at most) times the sum of the absolute products that
pass through the rounded intermediates (``packed_attention_bf16_slack``,
``heads_attention_bf16_slack``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
F32 = torch.float32
FLOOR = 2.0 ** -20
ULP_REL = 2.0 ** -7
# the end-to-end attention check: the share of values that may lie beyond
# one ulp or BEYOND_FLOOR of the largest magnitude
BEYOND_SHARE = 1e-4
BEYOND_FLOOR = 2.0 ** -12
# the Dense step: the share of values that may differ from the plain version
DENSE_APART = 1e-3


def _ulp(w):
    """One bfloat16 ulp of each |w| (float32)."""
    return torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                      - 7)


def _same_shape(name, got, want):
    if got.dtype != BF16 or want.dtype != BF16 or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    return got.float(), want.float()


def assert_bf16_within(name, got, want, floor=FLOOR):
    """Raise unless ``got`` and ``want`` are bfloat16 of one shape and
    |got - want| <= max(one ulp of |want|, floor * max|want|) everywhere;
    returns (the share of values that differ at all, the largest difference
    in units of that bound, the largest absolute difference)."""
    g, w = _same_shape(name, got, want)
    tol = torch.maximum(_ulp(w), floor * w.abs().max())
    diff = (g - w).abs()
    bad = diff > tol
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {w.numel()} values beyond the "
            f"bound, worst {float(diff.max()):.3e} on values up to "
            f"{float(w.abs().max()):.3e}")
    return (float((g != w).float().mean()), float((diff / tol).max()),
            float(diff.max()))


def assert_bf16_mostly_within(name, got, want, slack,
                              share=BEYOND_SHARE, floor=BEYOND_FLOOR):
    """Raise unless ``got`` and ``want`` are bfloat16 of one shape, at most
    ``share`` of the values lie beyond max(one ulp of |want|, floor *
    max|want|), and every value lies within that plus ``slack``; returns
    (the share of values that differ at all, the largest difference in
    units of that bound, the largest absolute difference, the share
    beyond)."""
    g, w = _same_shape(name, got, want)
    diff = (g - w).abs()
    tol = torch.maximum(_ulp(w), floor * w.abs().max())
    beyond = float((diff > tol).float().mean())
    over = diff > tol + slack
    if beyond > share or bool(over.any()):
        raise AssertionError(
            f"{name}: {beyond:.2e} of {w.numel()} values beyond one ulp "
            f"(at most {share:.0e}), {int(over.sum())} beyond the slack, "
            f"worst {float(diff.max()):.3e} on values up to "
            f"{float(w.abs().max()):.3e}")
    return (float((g != w).float().mean()), float((diff / tol).max()),
            float(diff.max()), beyond)


def assert_dense_within(name, got, a, w, b, share=DENSE_APART,
                        floor=FLOOR):
    """Raise unless ``got`` (..., N) bfloat16, the Dense step of the
    bfloat16 ``a`` (..., K), ``w`` (N, K) and ``b`` (N), lies everywhere
    between bfloat16(p - u + b) and bfloat16(p + u + b), p the plain
    product rounded to bfloat16 and u one ulp of it (widened by ``floor``
    times the largest magnitude), and at most ``share`` of its values
    differ from the plain version's; returns (the share that differs, the
    largest absolute difference)."""
    k = a.shape[-1]
    prod = (a.reshape(-1, k).to(F32) @ w.to(F32).t()).to(BF16).to(F32)
    want = (prod + b.to(F32)).to(BF16).reshape(got.shape)
    g, w_ = _same_shape(name, got, want)
    u = _ulp(prod)
    lo = (prod - u + b.to(F32)).to(BF16).to(F32).reshape(got.shape)
    hi = (prod + u + b.to(F32)).to(BF16).to(F32).reshape(got.shape)
    slack = floor * w_.abs().max()
    out = (g < lo - slack) | (g > hi + slack)
    apart = float((g != w_).float().mean())
    if bool(out.any()) or apart > share:
        raise AssertionError(
            f"{name}: {int(out.sum())} of {g.numel()} values outside the "
            f"Dense sums of the product's neighbours, {apart:.2e} of them "
            f"apart from the plain version (at most {share:.0e})")
    return apart, float((g - w_).abs().max())


def mlp_fwd_stages(x, w1, b1, w2, b2, a):
    """The plain values of the bfloat16 MLP forward's rounded outputs (o,
    a, s): a and s from x, o from the kernel's ``a``."""
    from vitta_tpu_torch.ops.cuda_mlp import gelu_derivative
    h = F.linear(x.to(F32), w1.to(F32), b1.to(F32))
    return (F.linear(a.to(F32), w2.to(F32), b2.to(F32)).to(BF16),
            F.gelu(h).to(BF16), gelu_derivative(h).to(BF16))


def ln_mlp_fwd_stages(x, gamma, beta, w1, b1, w2, b2, eps, y, a):
    """The plain values of the bfloat16 LayerNorm-MLP forward's rounded
    outputs (o, y, a, s), each from the kernel's own rounded inputs: y from
    x, a and s from the kernel's y, o from the kernel's a."""
    from vitta_tpu_torch.ops.cuda_ln import layer_norm_reference
    o, a_ref, s_ref = mlp_fwd_stages(y, w1, b1, w2, b2, a)
    return o, layer_norm_reference(x, gamma, beta, eps), a_ref, s_ref


def mlp_bwd_stages(x, a, s, g, w1, w2, dh, dhc):
    """The plain values of the bfloat16 MLP backward's steps, each from the
    kernel's own inputs to it (its float32 dh and rounded dhc, which
    ``mlp_bwd_cuda(..., taps=)`` hands out): {"dh" (float32), "dhc", "dy"
    (dhc w1, float32), "dx" (its rounded form), "dw1", "db1", "dw2",
    "db2"}; the LayerNorm-MLP's on its y in place of x."""
    g32, dhc32 = g.to(F32), dhc.to(F32)
    dy = dhc32 @ w1.to(F32)
    return {"dh": (g32 @ w2.to(F32)) * s.to(F32), "dhc": dh.to(BF16),
            "dy": dy, "dx": dy.to(BF16),
            "dw1": (dhc32.t() @ x.to(F32)).to(BF16),
            "db1": dh.sum(dim=0).to(BF16),
            "dw2": (g32.t() @ a.to(F32)).to(BF16),
            "db2": g32.sum(dim=0).to(BF16)}


def ln_mlp_bwd_stages(x, y, a, s, go, gy, gamma, w1, w2, eps, dh, dhc, dy):
    """The plain values of the bfloat16 LayerNorm-MLP backward's steps, each
    from the kernel's own inputs to it (dh, its rounded form dhc and dy as
    the kernel left them in its scratch): {"dh", "dhc", "dy" (float32 but
    dhc), "dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"}."""
    from vitta_tpu_torch.ops.cuda_ln import layer_norm_backward_reference
    out = mlp_bwd_stages(y, a, s, go, w1, w2, dh, dhc)
    if gy is not None:
        out["dy"] = out["dy"] + gy.to(F32)
    out["dx"], out["dgamma"], out["dbeta"] = layer_norm_backward_reference(
        x, gamma, dy, eps)
    return out


def proj_fwd_stages(x, wqkv, bqkv, wproj, bproj, o_att):
    """The plain values of the bfloat16 projection-fused forward's two
    Dense steps (qkv, out), each from the kernel's own rounded input: qkv
    from ``x`` (the LayerNorm form's y), out from the kernel's ``o_att``
    (``assert_dense_within`` holds the kernel's to them); the attention
    between them is held as the packed one is."""
    from vitta_tpu_torch.ops.cuda_attention_proj import dense_bf16
    return dense_bf16(x, wqkv, bqkv), dense_bf16(o_att, wproj, bproj)


def proj_bwd_stages(y, wqkv, wproj, o_att, g, gy, dqkv):
    """The plain values of the bfloat16 projection-fused backward's steps
    around its attention, each from the kernel's own inputs to it (its
    rounded dqkv, which ``attn_proj_bwd(..., taps=)`` hands out): {"g_att",
    "dy" (float32, dqkv wqkv + gy where ``gy`` is not None), "dx" (its
    rounded form, the form without the LayerNorm), "dwqkv", "dbqkv",
    "dwproj", "dbproj"}, on ``y``, the qkv product's input (x without the
    LayerNorm)."""
    c = y.shape[-1]
    g2, d2 = g.reshape(-1, c).to(F32), dqkv.reshape(-1, 3 * c).to(F32)
    dy = (d2 @ wqkv.to(F32)).reshape(y.shape)
    if gy is not None:
        dy = dy + gy.to(F32)
    return {"g_att": (g.to(F32) @ wproj.to(F32)).to(BF16), "dy": dy,
            "dx": dy.to(BF16),
            "dwqkv": (d2.t() @ y.reshape(-1, c).to(F32)).to(BF16),
            "dbqkv": d2.sum(dim=0).to(BF16),
            "dwproj": (g2.t() @ o_att.reshape(-1, c).to(F32)).to(BF16),
            "dbproj": g2.sum(dim=0).to(BF16)}


def _slack(q, k, v, logits, ms, gh, scale: float):
    """The bounds of ``packed_attention_bf16_slack`` in (B_, N, nh, hd):
    out's, then dq's, dk's and dv's, from float32 q, k, v, the logits and
    the cotangent ``gh``."""
    b_, n, nh, _hd = q.shape
    ms4 = ms.reshape(b_, n, nh, 2).permute(0, 2, 1, 3)
    e = torch.exp(logits - ms4[..., 0:1])
    inv = 1.0 / ms4[..., 1:2]
    out = torch.einsum("bhqk,bkhd->bqhd", e * inv, v.abs())
    gs = (gh * inv.permute(0, 2, 1, 3)).to(BF16).to(F32)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    rs = torch.sum(dp * e, dim=-1, keepdim=True) * inv
    dl = (e * (dp - rs) * inv).abs()
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k.abs()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q.abs()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", e, gs.abs())
    return tuple(ULP_REL * t for t in (out, dq, dk, dv))


def packed_attention_bf16_slack(qkv, bias, mask, ms, g, scale: float,
                                nh: int):
    """(out's, dqkv's) bound on what the attention's internally rounded
    intermediates may move them by: 2^-7 times sum_j p_ij |v_j| for out,
    sum_i e_ij |gs_i| for dv, scale sum_j |dl_ij| |k_j| for dq and
    scale sum_i |dl_ij| |q_i| for dk, in the layouts of out and dqkv."""
    from vitta_tpu_torch.ops.cuda_attention import _bf16_logits
    b_, n, c3 = qkv.shape
    q, k, v, logits = _bf16_logits(qkv, bias, mask, scale, nh)
    out, dq, dk, dv = _slack(q, k, v, logits, ms,
                             g.reshape(q.shape).to(F32), scale)
    return (out.reshape(b_, n, c3 // 3),
            torch.stack([dq, dk, dv], dim=2).reshape(b_, n, c3))


def heads_attention_bf16_slack(q, k, v, bias, mask, ms, g, scale: float):
    """``packed_attention_bf16_slack`` per (head, window): (out's, dq's,
    dk's, dv's) bounds, each (B_, N, nh, hd)."""
    from vitta_tpu_torch.ops.cuda_attention import _bf16_logits_of
    q, k, v, logits = _bf16_logits_of(q, k, v, bias, mask, scale)
    return _slack(q, k, v, logits, ms, g.to(F32), scale)


def _packed(qkv, ms, nh: int):
    """q, k, v float32 (B_, N, nh, hd) of the packed bfloat16 ``qkv`` and
    the row sums s (B_, N, nh) of the forward's ``ms``."""
    b_, n, c3 = qkv.shape
    q, k, v = qkv.reshape(b_, n, 3, nh, c3 // 3 // nh).to(F32).unbind(2)
    return q, k, v, ms.reshape(b_, n, nh, 2)[..., 1]


def _fwd_stage(v, s, e):
    """(e v) / s in float32 (B_, N, nh, hd) from the kernel's rounded e."""
    return torch.einsum("bhqk,bkhd->bqhd", e.to(F32), v) / s[..., None]


def _bwd_stages(q, k, s, gh, e, dl, scale: float):
    """dq, dk, dv in float32 (B_, N, nh, hd) from the kernel's rounded e and
    float32 dl: dv = e^T bfloat16(g / s), dq and dk from bfloat16(dl),
    times scale."""
    gs = (gh * (1.0 / s)[..., None]).to(BF16).to(F32)
    dlc = dl.to(BF16).to(F32)
    dq = torch.einsum("bhqk,bkhd->bqhd", dlc, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dlc, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", e.to(F32), gs)
    return dq, dk, dv


def packed_attention_bf16_fwd_stage(qkv, ms, e, nh: int):
    """The plain out of the bfloat16 attention forward from the kernel's own
    rounded ``e`` (B_, nh, N, N) and ``ms``: bfloat16((e v) / s)."""
    b_, n, c3 = qkv.shape
    _q, _k, v, s = _packed(qkv, ms, nh)
    return _fwd_stage(v, s, e).reshape(b_, n, c3 // 3).to(BF16)


def packed_attention_bf16_bwd_stages(qkv, ms, g, e, dl, scale: float,
                                     nh: int):
    """The plain dqkv of the bfloat16 attention backward from the kernel's
    own rounded ``e`` and float32 ``dl`` (B_, nh, N, N): dv =
    bfloat16(e^T bfloat16(g / s)), dq and dk from bfloat16(dl), times
    scale, rounded."""
    b_, n, c3 = qkv.shape
    q, k, _v, s = _packed(qkv, ms, nh)
    dq, dk, dv = _bwd_stages(q, k, s, g.reshape(q.shape).to(F32), e, dl,
                             scale)
    return torch.stack([dq, dk, dv], dim=2).reshape(b_, n, c3).to(BF16)


def heads_attention_bf16_fwd_stage(v, ms, e):
    """``packed_attention_bf16_fwd_stage`` per (head, window): out
    (B_, N, nh, hd) from v and the kernel's own ``e`` and ``ms``."""
    b_, n, nh, _hd = v.shape
    return _fwd_stage(v.to(F32), ms.reshape(b_, n, nh, 2)[..., 1],
                      e).to(BF16)


def heads_attention_bf16_bwd_stages(q, k, ms, g, e, dl, scale: float):
    """``packed_attention_bf16_bwd_stages`` per (head, window): (dq, dk,
    dv), each (B_, N, nh, hd) bfloat16."""
    b_, n, nh, _hd = q.shape
    return tuple(t.to(BF16) for t in _bwd_stages(
        q.to(F32), k.to(F32), ms.reshape(b_, n, nh, 2)[..., 1], g.to(F32),
        e, dl, scale))


def _intermediates(v, logits, ms, gh):
    """(bfloat16(e), dl float32) from float32 v, the logits, the kernel's
    ``ms`` and the float32 cotangent ``gh``."""
    b_, n, nh, _hd = v.shape
    ms4 = ms.reshape(b_, n, nh, 2).permute(0, 2, 1, 3)
    e = torch.exp(logits - ms4[..., 0:1])
    inv = 1.0 / ms4[..., 1:2]
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    rs = torch.sum(dp * e, dim=-1, keepdim=True) * inv
    return e.to(BF16), e * (dp - rs) * inv


def packed_attention_bf16_intermediates(qkv, bias, mask, ms, g, scale: float,
                                        nh: int):
    """The plain (bfloat16(e), dl float32), (B_, nh, N, N) each, from the
    logits and the kernel's row maximum and sum ``ms``: the values the
    kernels' e and dl are held to."""
    from vitta_tpu_torch.ops.cuda_attention import _bf16_logits
    _q, _k, v, logits = _bf16_logits(qkv, bias, mask, scale, nh)
    return _intermediates(v, logits, ms, g.reshape(v.shape).to(F32))


def heads_attention_bf16_intermediates(q, k, v, bias, mask, ms, g,
                                       scale: float):
    """``packed_attention_bf16_intermediates`` per (head, window)."""
    from vitta_tpu_torch.ops.cuda_attention import _bf16_logits_of
    _q, _k, v32, logits = _bf16_logits_of(q, k, v, bias, mask, scale)
    return _intermediates(v32, logits, ms, g.to(F32))


# the float32 intermediates and sums of the projection-fused check: dl, dy,
# dbias, dgamma and dbeta to this share of their tensor's largest magnitude
# (float32 sums in another order; tests/test_torch_cuda.py's GRAD_REL)
F32_REL = 2e-5
# the launches a bfloat16 projection-fused backward call may make
PROJ_BWD_BUDGET = {False: 8, True: 11}


def _rel_err(name, got, want, rel=F32_REL):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if err > rel * scale:
        raise AssertionError(f"{name}: {err:.3e} against {rel:.0e} of "
                             f"{scale:.3e}")
    return err / scale if scale else 0.0


def check_proj_bf16(x, ln, wqkv, bqkv, wproj, bproj, bias, mask,
                    scale: float, nh: int, g, gy=None):
    """Run the bfloat16 projection-fused kernels on the card (``ln`` =
    (gamma, beta, eps) for the LayerNorm form, else None), forward with ms
    and backward, tapped and not, and hold every step on the kernel's own
    rounded intermediates: y within one ulp; qkv and out by
    ``assert_dense_within`` (qkv from y, out from the kernel's o_att); the
    forward's e within one ulp of its plain value and o_att within one ulp
    of its plain value from that e, and end to end as the packed attention
    (``assert_bf16_mostly_within``); ms, dl, dy, dbias, dgamma and dbeta to
    ``F32_REL``; g_att within one ulp; the backward's e within one ulp and
    the forward's to the bit, dqkv within one ulp of its plain value from
    the kernel's e, dl and
    g_att, and end to end; dx (or, under the LayerNorm, dx from the
    kernel's dy), dwqkv, dbqkv, dwproj and dbproj within one ulp of their
    plain values from the kernel's dqkv; dbias against the kernel's dl
    summed over the windows in their order.  The tapped and untapped runs
    give the same bits, and so do two untapped backward runs.  Launches
    (the libraries' counts): 3 forward (4 with the LayerNorm), every one a
    bfloat16 instance; the backward the library's own count
    (``cuda_attention_proj.bf16_bwd_launches_cuda``), within
    ``PROJ_BWD_BUDGET``, three of them gemm_wgmma_bf16.  Returns {"fwd":
    the forward's outputs, "grads": the backward's, "err": the largest
    relative error of each float32 check, "apart": the share of each
    bfloat16 output an ulp from its plain value, "abs": the largest
    absolute difference of the forward's and of the backward's bfloat16
    outputs from their plain values, "launches": (forward, backward)}."""
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_attention_proj as cp
    from vitta_tpu_torch.ops._launch import launches_of
    from vitta_tpu_torch.ops.cuda_ln import (layer_norm_backward_reference,
                                             layer_norm_reference)
    w = (wqkv, bqkv, wproj, bproj)
    apart, err, absd = {}, {}, {"fwd": 0.0, "bwd": 0.0}

    def note(side, name, result):
        apart[name] = result[0]
        # (share, ratio, largest difference[, beyond]) or, from the Dense
        # bound, (share, largest difference)
        absd[side] = max(absd[side], result[2] if len(result) > 2
                         else result[1])

    def within(name, got, want, side="bwd"):
        note(side, name, assert_bf16_within(name, got, want))

    def fwd(taps=None):
        if ln is None:
            return cp.attn_proj_fwd(x, *w, bias, mask, scale, nh, True,
                                    taps=taps)
        return cp.attn_ln_proj_fwd(x, *ln, *w, bias, mask, scale, nh, True,
                                   taps=taps)

    def bwd(taps=None, y=None, qkv=None, o_att=None, ms=None):
        if ln is None:
            return cp.attn_proj_bwd(x, qkv, wqkv, wproj, bias, mask, o_att,
                                    ms, g, scale, nh, taps=taps)
        return cp.attn_ln_proj_bwd(x, y, qkv, ln[0], ln[2], wqkv, wproj,
                                   bias, mask, o_att, ms, g, gy, scale, nh,
                                   taps=taps)

    b_, n, c = x.shape
    names = launches_of(fwd)
    if (sum(names.values()) != 3 + (ln is not None)
            or names.get("attn_fwd_dense_bf16_kernel") != 1
            or sum(v for k, v in names.items()
                   if k.startswith("gemm_wgmma_bf16")) != 2
            or not all("bf16" in k or "bfloat16" in k for k in names)):
        raise AssertionError(f"forward launches {names}")
    n_fwd = sum(names.values())
    tf = {}
    outs = fwd(tf)
    if not all(torch.equal(p, q) for p, q in zip(outs, fwd())):
        raise AssertionError("the tapped forward differs from the untapped")
    if ln is None:
        out, qkv, o_att, ms = outs
        y = x
    else:
        out, y, qkv, o_att, ms = outs
        within("y", y, layer_norm_reference(x, *ln), "fwd")
    note("fwd", "qkv", assert_dense_within("qkv", qkv, y, wqkv, bqkv))
    note("fwd", "out", assert_dense_within("out", out, o_att, wproj, bproj))
    want_o, want_ms = ca.packed_attention_bf16_reference(qkv, bias, mask,
                                                         scale, nh, True)
    err["ms"] = _rel_err("ms", ms, want_ms)
    res = dict(y=y, qkv=qkv, o_att=o_att, ms=ms)
    grads = bwd(**res)
    names = launches_of(lambda: bwd(**res))
    want_n = cp.bf16_bwd_launches_cuda(b_, n, nh, c // nh, ln is not None)
    if (sum(names.values()) != want_n
            or want_n > PROJ_BWD_BUDGET[ln is not None]
            or names.get("attn_bwd_bf16_kernel") != 1
            or sum(v for k, v in names.items()
                   if k.startswith("gemm_wgmma_bf16")) != 3
            or any(k.startswith(("gemm_tiles", "attn_bwd_kernel",
                                 "attn_fwd", "ln_rows")) for k in names)):
        raise AssertionError(f"backward launches {names}, the library "
                             f"counts {want_n}")
    tb = {}
    tapped = bwd(tb, **res)
    again = bwd(**res)
    for other in (tapped, again):
        if not all(torch.equal(p, q) for p, q in zip(grads, other)):
            raise AssertionError("two backward runs differ")
    g_att = tb["g_att"]
    within("g_att", g_att, (g.float() @ wproj.float()).to(BF16))
    e_want, dl_want = packed_attention_bf16_intermediates(
        qkv, bias, mask, ms, g_att, scale, nh)
    within("forward e", tf["e"], e_want, "fwd")
    within("backward e", tb["e"], e_want)
    if not torch.equal(tf["e"], tb["e"]):
        raise AssertionError("the forward's e is not the backward's: "
                             f"{(tf['e'] != tb['e']).float().mean():.2e} of "
                             "values differ")
    err["dl"] = _rel_err("dl", tb["dl"], dl_want)
    within("o_att from the kernel's e", o_att,
           packed_attention_bf16_fwd_stage(qkv, ms, tf["e"], nh), "fwd")
    s_out, s_dqkv = packed_attention_bf16_slack(qkv, bias, mask, ms, g_att,
                                                scale, nh)
    note("fwd", "o_att end to end", assert_bf16_mostly_within(
        "o_att", o_att, want_o, s_out))
    within("dqkv from the kernel's e, dl and g_att", tb["dqkv"],
           packed_attention_bf16_bwd_stages(qkv, ms, g_att, tb["e"],
                                            tb["dl"], scale, nh))
    wq, _wb = ca.packed_attention_bf16_backward_reference(
        qkv, bias, mask, ms, g_att, scale, nh)
    note("bwd", "dqkv end to end", assert_bf16_mostly_within(
        "dqkv", tb["dqkv"], wq, s_dqkv))
    from vitta_tpu_torch.ops.cuda_attention import dbias_in_window_order
    st = proj_bwd_stages(y, wqkv, wproj, o_att, g, gy, tb["dqkv"])
    if ln is None:
        within("dx", grads[0], st["dx"])
        rest = grads[1:]
    else:
        err["dy"] = _rel_err("dy", tb["dy"], st["dy"])
        gx, gg, gb = layer_norm_backward_reference(
            x.reshape(-1, c), ln[0], tb["dy"].reshape(-1, c), ln[2])
        within("dx from the kernel's dy", grads[0], gx.to(BF16).reshape(
            x.shape))
        err["dgamma"] = _rel_err("dgamma", grads[1], gg)
        err["dbeta"] = _rel_err("dbeta", grads[2], gb)
        rest = grads[3:]
    for name, got in zip(("dwqkv", "dbqkv", "dwproj", "dbproj"), rest[:4]):
        within(name, got, st[name])
    want_dbias = dbias_in_window_order(tb["dl"], bias)
    err["dbias"] = _rel_err("dbias", rest[4], want_dbias)
    if not torch.equal(rest[4], want_dbias):
        raise AssertionError("dbias is not the kernel's dl added in window "
                             "order")
    return {"fwd": outs, "grads": grads, "err": err, "apart": apart,
            "abs": absd, "launches": (n_fwd, want_n)}
