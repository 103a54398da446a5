"""The matrix product gemm_tiles' arithmetic, emulated on the CPU.

vitta_tpu_torch/csrc/gemm_tiles.cuh computes every matrix product of the
port's MLP (csrc/mlp.cu) and projection-fused attention
(csrc/attention_proj.cu) on the tensor cores in split TF32: each float32
operand x = hi + lo, two tf32 values, and each k step of eight is lo*hi +
hi*lo + hi*hi; the four steps of a slice of 32 k are summed afresh and then
added to the running float32 sum (csrc/gemm_tiles.cuh); a weight
gradient's rows are cut into chunks whose partial products are added in
chunk order.  A CUDA kernel has no CPU mode, so tests/torch_tf32.py runs the
same steps, slices, order and chunks with torch on float32 tensors
(``gemm``, ``grad_gemm``, and ``attention_forward`` for the attention
between the two projections), each mma step's sum cut toward zero to
float32 as the tensor cores cut it.  That cut is why a slice's steps go to
a fresh accumulator: summed in place over K = 4096 it piles up past
``MLP_BWD_TOL``.

Held on numpy-seeded inputs, at K = 96, 128 and 4096 and a ragged number of
rows:
* each product against float64;
* the MLP without the LayerNorm (Video Swin-T's stages 1-2 and Swin-B's
  widths) against vitta_tpu's Pallas kernels ``_pallas_mlp_fwd`` and
  ``_pallas_mlp_bwd`` in interpret mode, the backward from the same a and s;
* the projection-fused attention (qkv projection, attention, output
  projection) against ``_proj_attn_fwd`` in interpret mode;
* at K = 4096, the fresh per-slice sums against the same steps summed in
  place.
Tolerances: chip_smoke.py's for the kernels against their plain versions on
the card, ``MLP_TOL`` (|error| <= 1e-4 + 1e-4 |value|) forward and
``MLP_BWD_TOL`` (2e-5 of each gradient's largest magnitude) backward.  The
same products with one tf32 product per step fail them, which is why the
kernel splits its operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import _proj_attn_fwd
from vitta_tpu.ops.pallas_mlp import _pallas_mlp_bwd, _pallas_mlp_fwd
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference

from tests.torch_tf32 import attention_forward, gemm, grad_gemm, grad_plan

torch.set_num_threads(1)

MLP_TOL = 1e-4        # |error| <= MLP_TOL + MLP_TOL |value|
MLP_BWD_TOL = 2e-5    # of each gradient's largest magnitude
GRADS = ("dx", "dw1", "db1", "dw2", "db2")


def _elementwise(got, want):
    """Largest |error| / (1 + |value|): at most MLP_TOL where the forward's
    tolerance holds everywhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def _scaled(got, want):
    """Largest |error| over the largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _gelu_parts(h):
    """a = h Phi(h) and s = Phi(h) + h phi(h), as gemm_tiles' GELU epilogue."""
    phi = 0.5 * (1 + torch.erf(h * 0.7071067811865476))
    return h * phi, phi + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


def _mlp_inputs(m, c, seed):
    """x (M, C), w1 (F, C), b1, w2 (C, F), b2, cotangent g (M, C): nn.Linear
    layouts, activations of the spread chip_smoke.py draws."""
    rng = np.random.default_rng(seed)
    f = 4 * c
    x = (1.5 * rng.normal(size=(m, c))).astype(np.float32)
    w1 = (rng.normal(size=(f, c)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(c, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=(m, c)).astype(np.float32)
    return x, w1, b1, w2, b2, g


def _mlp_forward(x, w1, b1, w2, b2, passes=3):
    """(o, a, s) as mlp.cu computes them: gemm_tiles<GELU> then <BIAS>."""
    a, s = _gelu_parts(gemm(x, w1.t(), passes) + b1)
    return gemm(a, w2.t(), passes) + b2, a, s


def _mlp_backward(x, a, s, g, w1, w2, passes=3):
    """(dx, dw1, db1, dw2, db2) as mlp.cu computes them: dh = (g w2) * s,
    dx = dh w1 (gemm_tiles<MUL>, <ADD>), the weight gradients over all rows
    in chunks, the bias gradients as column sums."""
    dh = gemm(g, w2, passes) * s
    return (gemm(dh, w1, passes), grad_gemm(dh, x, passes), dh.sum(0),
            grad_gemm(g, a, passes), g.sum(0))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# (rows, K): K = 96 and 128 (Swin-T's and Swin-B's first widths; the MLP's
# second product then contracts over 384 and 512), and K = 4096 (Swin-B's
# last stage, the second product of C = 1024); rows ragged
GEMM_CASES = [(1003, 96), (1003, 128), (75, 4096)]


@pytest.mark.parametrize("m,k", GEMM_CASES)
def test_split_tf32_products_match_float64(m, k):
    """An activation times a weight, and a weight gradient over all rows in
    the chunks launch_grad_gemm cuts, against float64; one tf32 product per
    step misses both tolerances."""
    rng = np.random.default_rng(m + k)
    a = _t(1.5 * rng.normal(size=(m, k)))
    w = _t(rng.normal(size=(k, 256)) / np.sqrt(k))
    want = a.double() @ w.double()
    assert _elementwise(gemm(a, w), want) <= MLP_TOL
    assert _scaled(gemm(a, w), want) <= MLP_BWD_TOL
    assert _scaled(gemm(a, w, passes=1), want) > 5 * MLP_BWD_TOL
    g = _t(rng.normal(size=(m, 256)))
    want_g = a.double().t() @ g.double()
    assert _scaled(grad_gemm(a, g), want_g) <= MLP_BWD_TOL
    assert _scaled(grad_gemm(a, g, passes=1), want_g) > 5 * MLP_BWD_TOL


def test_grad_plan_cuts_rows_in_chunks():
    """Swin-B's stage-1 weight gradients take chunks of a multiple of 32
    rows, two blocks an SM at most; the 1003 rows of the tests above take
    three chunks, 75 rows one."""
    splits, kchunk = grad_plan(512, 128, 50176)
    assert kchunk % 32 == 0 and splits * kchunk >= 50176 > (splits - 1) * kchunk
    assert splits == 66
    assert grad_plan(384, 96, 1003) == (3, 352)
    assert grad_plan(4096, 1024, 75) == (1, 96)


@pytest.mark.parametrize("m,c", [(1003, 96), (1003, 128), (75, 1024)])
def test_split_tf32_mlp_matches_the_pallas_kernels(m, c):
    """The MLP's two forward and four backward products against vitta_tpu's
    Pallas MLP kernels in interpret mode (their Dense kernels (in, out)),
    the backward from the same a and s."""
    x, w1, b1, w2, b2, g = _mlp_inputs(m, c, seed=m + c)
    o, a, s = _mlp_forward(*(_t(v) for v in (x, w1, b1, w2, b2)))
    want = _pallas_mlp_fwd(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1),
                           jnp.asarray(w2.T), jnp.asarray(b2), True,
                           interpret=True)
    errs = {nm: _elementwise(p, q) for nm, p, q in zip("oas", (o, a, s),
                                                        want)}
    assert max(errs.values()) <= MLP_TOL, errs
    got = _mlp_backward(_t(x), a, s, _t(g), _t(w1), _t(w2))
    dx, dw1, dw2, db1, db2 = _pallas_mlp_bwd(
        jnp.asarray(x), jnp.asarray(a.numpy()), jnp.asarray(s.numpy()),
        jnp.asarray(g), jnp.asarray(w1.T), jnp.asarray(w2.T), interpret=True)
    want_b = (dx, np.asarray(dw1).T, np.asarray(db1)[0], np.asarray(dw2).T,
              np.asarray(db2)[0])
    errs = {nm: _scaled(p, q) for nm, p, q in zip(GRADS, got, want_b)}
    assert max(errs.values()) <= MLP_BWD_TOL, errs


def _proj_inputs(c, nh, b_, seed):
    """x (B_, N, C) over 7x7x2 windows, wqkv (3C, C), bqkv, wproj (C, C),
    bproj, the dense bias (nh, N, N) and a 0 / -100 shift mask (2, N, N)."""
    rng = np.random.default_rng(seed)
    wd, hw = 2, 49
    n = wd * hw
    x = (1.5 * rng.normal(size=(b_, n, c)) + 0.3).astype(np.float32)
    wqkv = (rng.normal(size=(3 * c, c)) / np.sqrt(c)).astype(np.float32)
    bqkv = (0.1 * rng.normal(size=3 * c)).astype(np.float32)
    wproj = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    bproj = (0.1 * rng.normal(size=c)).astype(np.float32)
    vc = rng.normal(size=(nh, 2 * wd - 1, hw, hw)).astype(np.float32)
    dense = expand_bias_reference(_t(vc), wd).numpy()
    mask = np.where(rng.random((2, n, n)) < 0.3, -100.0, 0.0).astype(
        np.float32)
    mask[:, np.arange(n), np.arange(n)] = 0.0
    return x, wqkv, bqkv, wproj, bproj, dense, mask


@pytest.mark.parametrize("c,nh", [(96, 3), (128, 4)])
def test_split_tf32_proj_attention_matches_the_pallas_kernel(c, nh):
    """qkv = x wqkv^T + bqkv, the attention forward, out = o_att wproj^T +
    bproj, all in split TF32, against vitta_tpu's projection-fused Pallas
    kernel in interpret mode: out, o_att and the rows' maximum and sum."""
    x, wqkv, bqkv, wproj, bproj, dense, mask = _proj_inputs(c, nh, 4, c)
    b_, n, _ = x.shape
    hd, scale = c // nh, (c // nh) ** -0.5
    qkv = gemm(_t(x).reshape(b_ * n, c), _t(wqkv).t()) + _t(bqkv)
    q, k, v = qkv.reshape(b_, n, 3, nh, hd).unbind(2)
    o_att, ms = attention_forward(q, k, v, _t(dense), _t(mask), scale)
    o_att = o_att.reshape(b_ * n, c)
    out = gemm(o_att, _t(wproj).t()) + _t(bproj)
    want = _proj_attn_fwd(
        jnp.asarray(x), jnp.asarray(wqkv.T), jnp.asarray(bqkv[None]),
        jnp.asarray(wproj.T), jnp.asarray(bproj[None]), jnp.asarray(dense),
        jnp.asarray(mask), scale, nh, save_res=True, interpret=True)
    errs = {nm: _elementwise(p.reshape(np.shape(q_)), q_)
            for nm, p, q_ in zip(("out", "o_att", "ms"), (out, o_att, ms),
                                 want)}
    assert max(errs.values()) <= MLP_TOL, errs


def test_mlp_with_one_tf32_product_fails_the_tolerances():
    """At K = 4096 (Swin-B's last stage) one tf32 product per step takes
    the MLP's output and gradients outside MLP_TOL and MLP_BWD_TOL, where
    the split keeps them inside."""
    x, w1, b1, w2, b2, g = _mlp_inputs(75, 1024, seed=7)
    xt, w1t, b1t, w2t, b2t, gt = (_t(v) for v in (x, w1, b1, w2, b2, g))
    o64, a64, s64 = (t.double() for t in _mlp_forward(xt, w1t, b1t, w2t, b2t))
    want_o = ((_gelu_parts(xt.double() @ w1t.double().t() + b1t.double())[0])
              @ w2t.double().t() + b2t.double())
    o1 = _mlp_forward(xt, w1t, b1t, w2t, b2t, passes=1)[0]
    assert _elementwise(o64, want_o) <= MLP_TOL
    assert _elementwise(o1, want_o) > MLP_TOL
    a, s = a64.float(), s64.float()
    dh = (gt.double() @ w2t.double()) * s.double()
    want_b = (dh @ w1t.double(), dh.t() @ xt.double())
    for passes, inside in ((3, True), (1, False)):
        got = _mlp_backward(xt, a, s, gt, w1t, w2t, passes)[:2]
        errs = [_scaled(p, q) for p, q in zip(got, want_b)]
        assert (max(errs) <= MLP_BWD_TOL) if inside else \
            (min(errs) > 5 * MLP_BWD_TOL), (passes, errs)


@pytest.mark.parametrize("case", ["product", "mlp dx"])
def test_in_place_sums_fail_at_k_4096(case):
    """At K = 4096 (Swin-B's last stage) the fresh per-slice sums stay
    within MLP_BWD_TOL of float64 and the same steps summed in place in one
    accumulator do not: every mma step's cut toward zero adds up.  The
    products are an activation times a weight and the MLP backward's
    dx = dh w1 at C = 1024."""
    if case == "product":
        rng = np.random.default_rng(4096)
        a = _t(1.5 * rng.normal(size=(75, 4096)))
        b = _t(rng.normal(size=(4096, 256)) / np.sqrt(4096))
    else:
        x, w1, b1, w2, b2, g = (_t(v) for v in _mlp_inputs(75, 1024, seed=11))
        _o, _a, s = _mlp_forward(x, w1, b1, w2, b2)
        a, b = gemm(g, w2) * s, w1
    want = a.double() @ b.double()
    fresh = _scaled(gemm(a, b), want)
    in_place = _scaled(gemm(a, b, fresh=False), want)
    assert fresh <= MLP_BWD_TOL < in_place, (fresh, in_place)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gemm_tf32.py
    # prints each product's error against float64, split TF32 with fresh
    # per-slice sums and summed in place, and one tf32 product, at the
    # tests' shapes
    for m, k in GEMM_CASES:
        rng = np.random.default_rng(m + k)
        a = _t(1.5 * rng.normal(size=(m, k)))
        w = _t(rng.normal(size=(k, 256)) / np.sqrt(k))
        want = a.double() @ w.double()
        for passes, fresh in ((3, True), (3, False), (1, True)):
            got = gemm(a, w, passes, fresh)
            print(f"M={m} K={k} {passes} tf32 product(s), "
                  f"{'fresh sums a slice' if fresh else 'summed in place'}: "
                  f"{_elementwise(got, want):.2e} of 1 + |value|, "
                  f"{_scaled(got, want):.2e} of the largest value")
