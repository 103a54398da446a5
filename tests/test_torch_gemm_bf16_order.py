"""The summation plan of the bfloat16 LayerNorm-MLP's wgmma core
(vitta_tpu_torch/csrc/gemm_wgmma_bf16.cuh) emulated in torch on the CPU,
against vitta_tpu's Pallas kernels at bfloat16 (_lnmlp_fwd_kernel and
_lnmlp_bwd_kernel, vitta_tpu/ops/pallas_mlp.py:303-369) in interpret mode,
as vitta_tpu's own tests run them.

The core sums each product in float32 slice by slice: every 64-deep slice
of K into fresh sums (exact bfloat16 products; the order inside a slice is
the tensor cores' and is left to torch here), each added to the running
sum; a weight gradient in the chunks of K that ``cuda_mlp.bf16_gemm_plan``
gives (the library's own plan on the card, tests/test_torch_cuda.py), the
chunks' partials added in chunk order; db1, dh's column sums, in the dh
product's epilogue a block of 64 rows at a time (``core_colsum``), the
blocks added in order; every output rounded once, in the epilogue or the
ordered sum.  The shapes are small (C 64 and 128, F = 4C)
with M ragged (77) and large enough that the weight gradients' K = M is cut
into two chunks (1100).

Tolerances, fixed before the comparisons, and why (those of
tests/test_torch_bf16_swin_kernels.py): a bfloat16 output within one
bfloat16 ulp of vitta_tpu's or 2^-20 of the tensor's largest magnitude
(``tools/bf16_checks.py:assert_bf16_within``'s floor) where both round the
same float32 value of the same rounded inputs: y; a and s from
vitta_tpu's own y, o from its a; dw2 from its a; db1, db2.  dx and dw1 are
made from dhc, dh rounded inside the backward, which vitta_tpu's kernel
does not hand out: a few of its values lie an ulp apart, each moving an
output by up to an ulp of one term, so their floor is 2^-12 of the
largest magnitude.  dgamma and dbeta (float32) to 5e-5 of their largest
value.  That the emulated cut of K is the library's own is checked on the
card (tests/test_torch_cuda.py: test_bf16_gemm_plan_matches_the_kernels).

The projection-fused attention (vitta_attn_proj_{fwd,bwd}_bf16,
csrc/attention_proj.cu) runs six products of the same layouts on the core
by the plan ``cuda_attention_proj.bf16_gemm_plan`` gives (its two weight
gradients share one launch and its chunks of K), against vitta_tpu's
_proj_attn_fwd and _proj_attn_bwd (pallas_attention.py:724-782): qkv and
out through the Dense epilogue (``EPI_DENSE``: the float32 sum rounded,
the bfloat16 bias added, the sum rounded again), held as the emulated
product against vitta_tpu's rounded product (rebuilt outside its kernel:
jnp.dot at bfloat16, which gives its o_att, and so its qkv, bit for bit,
through its packed kernel) to ``DIRECT`` and the Dense step from
vitta_tpu's product bit for bit; g_att, dx (from vitta_tpu's dqkv, rebuilt
the same way, which gives its dx bit for bit) and the weight gradients to
``DIRECT``; dbqkv and dbproj as the column partials of 256 rows
(``colsum_partials``: 8 rows in flight, each row's share added in order,
then the 8 in order) added in order by one ordered sum, to ``DIRECT``.

The MLP without the LayerNorm (vitta_mlp_{fwd,bwd}_bf16, Swin-T's widths 96
and 192) runs the same six products on x by the same plan, against
vitta_tpu's _fwd_kernel and _bwd_kernel (pallas_mlp.py:138-183); its dx
(dhc w1, rounded in the epilogue) and dw1 are held to ``DIRECT`` on
vitta_tpu's own dhc, rebuilt outside its kernel by the kernel's first
product (which gives its dx and dw1 bit for bit), and the emulated dhc
within one ulp of it (tests/test_torch_bf16_swin_t_kernels.py says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import (_packed_attn_bwd,
                                            _packed_attn_fwd, _proj_attn_bwd,
                                            _proj_attn_fwd)
from vitta_tpu.ops.pallas_mlp import (_pallas_lnmlp_bwd, _pallas_lnmlp_fwd,
                                      _pallas_mlp_bwd, _pallas_mlp_fwd)
from vitta_tpu_torch.ops import cuda_attention_proj as cap
from vitta_tpu_torch.ops.cuda_ln import (layer_norm_backward_reference,
                                         layer_norm_reference)
from vitta_tpu_torch.ops.cuda_mlp import bf16_gemm_plan, gelu_derivative
from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
SLICE = 64
DIRECT = 2.0 ** -20
CHAINED = 2.0 ** -12
SHAPES = [(77, 64), (77, 128), (1100, 64), (1100, 128)]
# the MLP without the LayerNorm: Swin-T's first width (1.5 slices of 64, a
# ragged 128-wide tile) and a narrower one
MLP_SHAPES = [(77, 96), (1100, 96), (77, 48)]


def _jbf16(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _t(a):
    arr = jnp.asarray(a)
    t = torch.from_numpy(np.asarray(arr.astype(jnp.float32)).copy())
    return t.to(BF16) if arr.dtype == jnp.bfloat16 else t


def core_product(a, b, kchunk):
    """sum over k of a[:, k] b[k, :] (float32 values of bfloat16 operands,
    a (M, K), b (K, N)) as the core adds it: chunks of ``kchunk`` rows of K,
    each the running float32 sum of its 64-deep slices' fresh sums, then
    the chunks in order."""
    k = a.shape[1]
    total = None
    for k0 in range(0, k, kchunk):
        run = torch.zeros(a.shape[0], b.shape[1], dtype=F32)
        for s0 in range(k0, min(k, k0 + kchunk), SLICE):
            run = run + a[:, s0:s0 + SLICE] @ b[s0:s0 + SLICE]
        total = run if total is None else total + run
    return total


def core_colsum(dh):
    """The column sums of dh (M, F) float32 as the dh product's epilogue and
    reduce_partials add them: per 64 rows, each of 8 threads a column its
    rows g + 8 i (i in order), then the 8 in order; the blocks of 64 rows in
    order."""
    total = None
    for b0 in range(0, dh.shape[0], 64):
        blk = torch.zeros(64, dh.shape[1], dtype=F32)
        rows = dh[b0:b0 + 64]
        blk[:rows.shape[0]] = rows
        grp = blk.view(8, 8, -1)            # [i][g] is row g + 8 i
        per = grp[0]
        for i in range(1, 8):
            per = per + grp[i]
        part = per[0]
        for g in range(1, 8):
            part = part + per[g]
        total = part if total is None else total + part
    return total


def colsum_partials(x):
    """The column sums of x (M, N) float32 as the projection-fused
    backward adds its bias gradients (reduce.cuh: col_sums2_kernel, then
    reduce_sums): per 256 rows, each of 8 warps its rows r0 + w, r0 + w +
    8, ... in order, then the 8 warps in order; the 256-row partials in
    order."""
    total = None
    for r0 in range(0, x.shape[0], 256):
        rows = x[r0:r0 + 256]
        part = None
        for w in range(8):
            acc = torch.zeros(x.shape[1], dtype=F32)
            for r in range(w, rows.shape[0], 8):
                acc = acc + rows[r]
            part = acc if part is None else part + acc
        total = part if total is None else total + part
    return total


def _inputs(m, c, seed):
    f = 4 * c
    rng = np.random.default_rng(seed)
    return dict(
        x=_jbf16(rng.normal(size=(m, c)) * 2 + 0.5),
        g=jnp.asarray(1 + 0.1 * rng.normal(size=c), jnp.float32),
        bt=jnp.asarray(0.1 * rng.normal(size=c), jnp.float32),
        w1=_jbf16(rng.normal(size=(c, f)) / np.sqrt(c)),      # (in, out)
        b1=_jbf16(0.1 * rng.normal(size=f)),
        w2=_jbf16(rng.normal(size=(f, c)) / np.sqrt(f)),
        b2=_jbf16(0.1 * rng.normal(size=c)),
        go=_jbf16(rng.normal(size=(m, c))),
        gy=_jbf16(0.1 * rng.normal(size=(m, c))))


def _within(name, got, want, floor):
    want = want if isinstance(want, torch.Tensor) else _t(want)
    share, _ulps, _err = assert_bf16_within(name, got, want, floor=floor)
    print(f"{name}: {share:.2e} of values an ulp apart")


def _rel(name, got, want, rel):
    w = np.asarray(want, np.float64).reshape(tuple(got.shape))
    err = float(np.abs(got.numpy().astype(np.float64) - w).max())
    assert err <= rel * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("m,c", SHAPES, ids=str)
def test_core_plan_matches_pallas(m, c):
    f = 4 * c
    plan = bf16_gemm_plan(m, c, f)
    if m == 1100:   # the weight gradients' K is cut, the row products' not
        assert plan["dw1"]["splits"] == plan["dw2"]["splits"] == 2
    assert all(plan[k]["splits"] == 1 for k in ("h", "o", "dh", "dy"))
    p = _inputs(m, c, 31 * m + c)
    o, y, a, s = _pallas_lnmlp_fwd(p["x"], p["g"], p["bt"], p["w1"], p["b1"],
                                   p["w2"], p["b2"], 1e-5, True,
                                   interpret=True)
    w1t = _t(p["w1"]).float().t()          # the port's (F, C), as float32
    w2t = _t(p["w2"]).float().t()          # (C, F)
    ch = lambda k: plan[k]["kchunk"]
    # the forward: y by the LayerNorm kernel's twin; h from vitta_tpu's y
    # and o from its a by the core
    yk = layer_norm_reference(_t(p["x"]), _t(p["g"]), _t(p["bt"]), 1e-5)
    _within("y", yk, y, DIRECT)
    h = core_product(_t(y).float(), w1t.t(), ch("h")) + _t(p["b1"]).float()
    _within("a", torch.nn.functional.gelu(h).to(BF16), a, DIRECT)
    _within("s", gelu_derivative(h).to(BF16), s, DIRECT)
    ok = (core_product(_t(a).float(), w2t.t(), ch("o"))
          + _t(p["b2"]).float()).to(BF16)
    _within("o", ok, o, DIRECT)
    # the backward from vitta_tpu's residuals, with and without gy
    y32, a32, s32 = _t(y).float(), _t(a).float(), _t(s).float()
    go32 = _t(p["go"]).float()
    for gy in (p["gy"], None):
        want = _pallas_lnmlp_bwd(
            p["x"], y, a, s, p["go"],
            jnp.zeros_like(p["go"]) if gy is None else gy, p["g"], p["w1"],
            p["w2"], 1e-5, interpret=True)
        dx, dg, dbt, dw1, dw2, db1, db2 = want
        dh = core_product(go32, w2t, ch("dh")) * s32
        dhc = dh.to(BF16).float()
        dy = core_product(dhc, w1t, ch("dy"))
        if gy is not None:
            dy = dy + _t(gy).float()
        gx, gg, gb = layer_norm_backward_reference(_t(p["x"]), _t(p["g"]),
                                                   dy, 1e-5)
        bf = jnp.bfloat16
        _within("dx", gx, dx, CHAINED)
        _rel("dgamma", gg, dg, 5e-5)
        _rel("dbeta", gb, dbt, 5e-5)
        _within("dw1", core_product(dhc.t(), y32, ch("dw1")).to(BF16).t(),
                dw1.astype(bf), CHAINED)
        _within("dw2", core_product(go32.t(), a32, ch("dw2")).to(BF16).t(),
                dw2.astype(bf), DIRECT)
        _within("db1", core_colsum(dh).to(BF16), db1[0].astype(bf), DIRECT)
        _within("db2", go32.sum(dim=0).to(BF16), db2[0].astype(bf), DIRECT)


@pytest.mark.parametrize("m,c", MLP_SHAPES, ids=str)
def test_mlp_core_plan_matches_pallas(m, c):
    f = 4 * c
    plan = bf16_gemm_plan(m, c, f)
    if m == 1100:
        assert plan["dw1"]["splits"] == plan["dw2"]["splits"] == 2
    p = _inputs(m, c, 17 * m + c)
    o, a, s = _pallas_mlp_fwd(p["x"], p["w1"], p["b1"], p["w2"], p["b2"],
                              True, interpret=True)
    w1t = _t(p["w1"]).float().t()          # the port's (F, C), as float32
    w2t = _t(p["w2"]).float().t()          # (C, F)
    ch = lambda k: plan[k]["kchunk"]
    x32 = _t(p["x"]).float()
    h = core_product(x32, w1t.t(), ch("h")) + _t(p["b1"]).float()
    _within("a", torch.nn.functional.gelu(h).to(BF16), a, DIRECT)
    _within("s", gelu_derivative(h).to(BF16), s, DIRECT)
    ok = (core_product(_t(a).float(), w2t.t(), ch("o"))
          + _t(p["b2"]).float()).to(BF16)
    _within("o", ok, o, DIRECT)
    dx, dw1, dw2, db1, db2 = _pallas_mlp_bwd(p["x"], a, s, p["go"], p["w1"],
                                             p["w2"], interpret=True)
    bf, f32 = jnp.bfloat16, jnp.float32
    dot = lambda u, w, ax: jax.lax.dot_general(
        u, w, (ax, ((), ())), preferred_element_type=f32)
    dhc_j = (dot(p["go"], p["w2"], ((1,), (1,))) * s.astype(f32)).astype(bf)
    assert bool((dot(dhc_j, p["w1"], ((1,), (1,))).astype(bf) == dx).all())
    assert bool((dot(p["x"], dhc_j, ((0,), (0,))) == dw1).all())
    go32 = _t(p["go"]).float()
    dh = core_product(go32, w2t, ch("dh")) * _t(s).float()
    _within("dhc", dh.to(BF16), dhc_j, DIRECT)
    dhc = _t(dhc_j).float()
    _within("dx", core_product(dhc, w1t, ch("dy")).to(BF16), dx, DIRECT)
    _within("dw1", core_product(dhc.t(), x32, ch("dw1")).to(BF16).t(),
            dw1.astype(bf), DIRECT)
    _within("dw2", core_product(go32.t(), _t(a).float(), ch("dw2")).to(
        BF16).t(), dw2.astype(bf), DIRECT)
    _within("db1", core_colsum(dh).to(BF16), db1[0].astype(bf), DIRECT)
    _within("db2", go32.sum(dim=0).to(BF16), db2[0].astype(bf), DIRECT)


# (windows, heads, head dim) of the projection-fused attention on (2, 3, 3)
# windows of 18 tokens: M = 72, and M = 1152, whose weight gradients' K is
# cut into chunks
PROJ_SHAPES = [(4, 2, 16), (64, 2, 32)]


@pytest.mark.parametrize("b_,nh,hd", PROJ_SHAPES, ids=str)
def test_proj_core_plan_matches_pallas(b_, nh, hd):
    n, c = 18, nh * hd
    m = b_ * n
    plan = cap.bf16_gemm_plan(m, c)
    if m > 1024:
        assert plan["dwqkv"]["splits"] > 1 and plan["dwproj"]["splits"] > 1
    ch = lambda k: plan[k]["kchunk"]
    rng = np.random.default_rng(5 * m + c)
    x = _jbf16(rng.normal(size=(b_, n, c)) * 1.5)
    w = _jbf16(rng.normal(size=(c, 3 * c)) / np.sqrt(c))      # (in, out)
    b = _jbf16(0.5 * rng.normal(size=3 * c))
    wp = _jbf16(rng.normal(size=(c, c)) / np.sqrt(c))
    bp = _jbf16(0.5 * rng.normal(size=c))
    bias = jnp.asarray(rng.normal(size=(nh, n, n)) * 0.5, jnp.float32)
    g = _jbf16(rng.normal(size=(b_, n, c)))
    scale = hd ** -0.5
    out, o_att, ms = _proj_attn_fwd(x, w, b.reshape(1, -1), wp,
                                    bp.reshape(1, -1), bias, None, scale, nh,
                                    save_res=True, interpret=True)
    bf, f32 = jnp.bfloat16, jnp.float32
    dot = lambda u, v, ax: jax.lax.dot_general(
        u, v, (ax, ((), ())), preferred_element_type=f32)
    prod_j = dot(x, w, ((2,), (0,))).astype(bf)
    qkv_j = prod_j + b
    assert bool((_packed_attn_fwd(qkv_j, bias, None, scale, nh,
                                  interpret=True) == o_att).all())
    prod_o = dot(o_att, wp, ((2,), (0,))).astype(bf)
    x32, o32 = _t(x).float().reshape(m, c), _t(o_att).float().reshape(m, c)
    wt, wpt = _t(w).float(), _t(wp).float()           # (in, out)
    for name, a, wgt, kk, prod, bb, want in (
            ("qkv", x32, wt, ch("qkv"), prod_j, b, qkv_j),
            ("out", o32, wpt, ch("out"), prod_o, bp, out)):
        core = core_product(a, wgt, kk).to(BF16)
        _within(f"{name} product", core, prod.reshape(m, -1), DIRECT)
        step = (_t(prod).float() + _t(bb).float()).to(BF16)
        assert torch.equal(step, _t(want)), name
    dx, dw, db, dwp, dbp, _dbias = _proj_attn_bwd(
        x, w, b.reshape(1, -1), wp, bias, None, o_att, ms, g, scale, nh,
        interpret=True)
    g_att = dot(g, wp, ((2,), (1,))).astype(bf)
    dqkv, _ = _packed_attn_bwd(qkv_j, bias, None, ms, g_att, scale, nh,
                               interpret=True)
    assert bool((dot(dqkv, w, ((2,), (1,))).astype(bf) == dx).all())
    g32 = _t(g).float().reshape(m, c)
    d32 = _t(dqkv).float().reshape(m, 3 * c)
    _within("g_att", core_product(g32, wpt.t(), ch("g_att")).to(BF16),
            g_att.reshape(m, c), DIRECT)
    _within("dx", core_product(d32, wt.t(), ch("dx")).to(BF16),
            dx.reshape(m, c), DIRECT)
    _within("dwqkv", core_product(d32.t(), x32, ch("dwqkv")).to(BF16).t(),
            dw.astype(bf), DIRECT)
    _within("dwproj", core_product(g32.t(), o32, ch("dwproj")).to(BF16).t(),
            dwp.astype(bf), DIRECT)
    _within("dbqkv", colsum_partials(d32).to(BF16), db[0].astype(bf),
            DIRECT)
    _within("dbproj", colsum_partials(g32).to(BF16), dbp[0].astype(bf),
            DIRECT)
