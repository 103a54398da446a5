"""The window-attention kernels' arithmetic, emulated on the CPU.

vitta_tpu_torch/csrc/attention_kernels.cuh computes the window attention,
forward (``attn_fwd_kernel``) and backward (``attn_bwd_kernel``), with its
matrix products on the tensor cores in split TF32 (csrc/tf32.cuh): every
float32 operand x is hi + lo, two tf32 values (10 mantissa bits; hi rounded
to nearest, lo the remainder x - hi cut to 10 bits), and each product of a
step of eight is lo*hi + hi*lo + hi*hi, three mma steps, each one's sum cut
toward zero to float32 as the tensor cores cut it.  A CUDA kernel has no
CPU mode, so the same algorithms run here with torch on float32 tensors,
the tf32 rounding done by bit arithmetic on ``view(torch.int32)``
(tests/torch_tf32.py):

* the backward, ``split_tf32_backward`` below: 16-row query strips; 32-key
  slabs, one per warp; s^T and dp^T per slab from the forward's row maximum
  and sum; rs and dq summed over the slabs in warp order; dk and dv
  accumulated in place over the strips, over several blocks' shares of the
  strips where a problem is split, the shares added in block order;
* the forward, ``torch_tf32.attention_forward``: 16-row query strips, keys
  in chunks of 32, the online softmax (a running maximum and sum per row, o
  rescaled where the maximum grows), p v from p as it lies, added to o in
  place over all keys, out = o / sum, and the rows' final maximum and sum.

They are held to the JAX package's kernels on the same numpy-seeded inputs,
in interpret mode: the per-(head, window) Pallas kernels ``_pallas_attn_fwd``
and ``_pallas_attn_bwd`` (the route of ``window_attention_heads``, dense
bias), the packed forward ``_packed_attn_fwd`` (out and the rows' maximum
and sum) and the packed op ``fused_window_attention_packed`` under
``jax.vjp``, dense and compact bias, at hd = 32, at Swin's N = 392 and at a
ragged N = 75, with and without a shift mask.  Tolerances: chip_smoke.py's
for the kernels against their plain versions on the card, each gradient
within ``ATTN_BWD_TOL`` = 2e-5 of its largest magnitude, the forward's out
and row maximum and sum within ``ATTN_TOL`` = 2e-5 + 2e-5 |value|.  The
same algorithms with one tf32 product per product fail those tolerances,
which is why the kernels split their operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from vitta_tpu.ops.pallas_attention import (_packed_attn_fwd,
                                            _pallas_attn_bwd,
                                            _pallas_attn_fwd,
                                            fused_window_attention_packed)
from vitta_tpu_torch.ops.cuda_attention import packed_attention_reference
from vitta_tpu_torch.ops.cuda_bias import (collapse_bias_reference,
                                           expand_bias_reference)

from tests.torch_tf32 import attention_forward, mm, split, tf32

torch.set_num_threads(1)

ATTN_BWD_TOL = 2e-5     # of each gradient's largest magnitude
ATTN_TOL = 2e-5         # |error| <= ATTN_TOL + ATTN_TOL |value|, forward
STRIP, SLAB, HD_PAD = 16, 32, 32


def _pad(x, rows):
    """(P, N, hd) -> (P, rows, HD_PAD) with zeros."""
    p_, n, hd = x.shape
    out = torch.zeros(p_, rows, HD_PAD)
    out[:, :n, :hd] = x
    return out


def split_tf32_backward(q, k, v, bias, mask, ms, g, scale, blocks=1,
                        passes=3):
    """(dq, dk, dv (B_, N, nh, hd), dl (B_, nh, N, N)) from q, k, v, g
    (B_, N, nh, hd), a dense bias (nh, N, N), a mask (nW, N, N) or None and
    the forward's ms (B_, N, 2nh), computed as attn_bwd_kernel does."""
    b_, n, nh, hd = q.shape
    probs = b_ * nh
    warps = -(-n // SLAB)
    strips = -(-n // STRIP)
    rows = strips * STRIP

    def per_problem(x):             # (B_, N, nh, hd) -> (P, N, hd)
        return x.permute(0, 2, 1, 3).reshape(probs, n, hd)

    qp, gp = (_pad(per_problem(x), rows) for x in (q, g))
    kw, vw = (_pad(per_problem(x), warps * SLAB).reshape(
        probs, warps, SLAB, HD_PAD) for x in (k, v))
    # the logits' additive part and the row maximum and sum, per problem
    add = bias[None].expand(b_, nh, n, n)
    if mask is not None:
        nw = mask.shape[0]
        add = (add.reshape(b_ // nw, nw, nh, n, n)
               + mask[None, :, None]).reshape(b_, nh, n, n)
    addp = torch.zeros(probs, rows, warps * SLAB)
    addp[:, :n, :n] = add.reshape(probs, n, n)
    m4 = ms.reshape(b_, n, nh, 2).permute(0, 2, 1, 3).reshape(probs, n, 2)
    rmax, rinv = torch.zeros(probs, rows), torch.zeros(probs, rows)
    rmax[:, :n] = m4[..., 0]
    rinv[:, :n] = 1.0 / m4[..., 1]
    valid = torch.zeros(rows, warps * SLAB, dtype=torch.bool)
    valid[:n, :n] = True

    dq = torch.zeros(probs, rows, HD_PAD)
    dl_all = torch.zeros(probs, rows, warps * SLAB)
    dk_parts, dv_parts = [], []
    for z in range(blocks):
        dka = torch.zeros(probs, warps, SLAB, HD_PAD)
        dva = torch.zeros(probs, warps, SLAB, HD_PAD)
        for s in range(z, strips, blocks):
            r0 = s * STRIP
            qs = qp[:, None, r0:r0 + STRIP]          # (P, 1, 16, HD_PAD)
            gs = gp[:, None, r0:r0 + STRIP]
            st = mm(kw, qs.transpose(-1, -2), passes)    # (P, W, 32, 16)
            dpt = mm(vw, gs.transpose(-1, -2), passes)
            addt = addp[:, r0:r0 + STRIP].reshape(
                probs, STRIP, warps, SLAB).permute(0, 2, 3, 1)
            ok = valid[r0:r0 + STRIP].reshape(STRIP, warps, SLAB).permute(
                1, 2, 0)
            p = torch.exp(st * scale + addt
                          - rmax[:, None, None, r0:r0 + STRIP]) \
                * rinv[:, None, None, r0:r0 + STRIP]
            p = torch.where(ok, p, torch.zeros(()))
            part = (dpt * p).sum(dim=2)                   # (P, W, 16)
            rs = torch.zeros(probs, STRIP)
            for w in range(warps):                        # in warp order
                rs = rs + part[:, w]
            dlt = p * (dpt - rs[:, None, None, :])       # (P, W, 32, 16)
            dva = mm(p, gs, passes, out=dva)          # in place, as the
            dka = mm(dlt, qs, passes, out=dka)        # kernel's registers
            shares = mm(dlt.transpose(-1, -2), kw, passes)   # (P, W, 16, 32)
            total = torch.zeros(probs, STRIP, HD_PAD)
            for w in range(warps):
                total = total + shares[:, w]
            dq[:, r0:r0 + STRIP] = total * scale
            dl_all[:, r0:r0 + STRIP] = dlt.permute(0, 3, 1, 2).reshape(
                probs, STRIP, warps * SLAB)
        dk_parts.append(dka)
        dv_parts.append(dva)
    dk_sum, dv_sum = dk_parts[0], dv_parts[0]
    for dka, dva in zip(dk_parts[1:], dv_parts[1:]):     # in block order
        dk_sum, dv_sum = dk_sum + dka, dv_sum + dva

    def back(x):                    # (P, rows, HD_PAD) -> (B_, N, nh, hd)
        return x[:, :n, :hd].reshape(b_, nh, n, hd).permute(0, 2, 1, 3)

    dk = back(dk_sum.reshape(probs, warps * SLAB, HD_PAD) * scale)
    dv = back(dv_sum.reshape(probs, warps * SLAB, HD_PAD))
    dl = dl_all[:, :n, :n].reshape(b_, nh, n, n)
    return back(dq), dk, dv, dl


def window_sum(dl):
    """dbias: dl summed over the windows in their order, as
    dbias_reduce_kernel sums it."""
    out = torch.zeros_like(dl[0])
    for b in range(dl.shape[0]):
        out = out + dl[b]
    return out


# ---------------------------------------------------------------- inputs
WINDOWS = {392: (8, 7, 7), 75: (3, 5, 5)}


def _inputs(n, with_mask, b_=2, nh=2, hd=32, nw=2, seed=0):
    """Numpy-seeded q, k, v, g (B_, N, nh, hd), the compact bias
    (nh, 2wd-1, hw, hw), a 0 / -100 mask (nW, N, N) or None; logits of
    Swin's spread (q, k ~ N(0, 1), the bias as drawn at std 0.5 by
    chip_smoke.py's full slices, then 1)."""
    rng = np.random.default_rng(seed)
    wd, wh, ww = WINDOWS[n]
    hw = wh * ww
    qkv = rng.normal(size=(b_, n, 3, nh, hd)).astype(np.float32)
    g = rng.normal(size=(b_, n, nh, hd)).astype(np.float32)
    vc = rng.normal(size=(nh, 2 * wd - 1, hw, hw)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0).astype(
            np.float32)
        idx = np.arange(n)
        mask[:, idx, idx] = 0.0         # a token always sees itself
    return qkv, g, vc, mask, wd


def _forward_ms(qkv, dense, mask, scale):
    """The row maximum and sum the forward keeps, (B_, N, 2nh)."""
    b_, n, _, nh, hd = qkv.shape
    _out, ms = packed_attention_reference(
        torch.from_numpy(qkv).reshape(b_, n, 3 * nh * hd), dense,
        None if mask is None else torch.from_numpy(mask), scale, nh,
        save_ms=True)
    return ms


def _emulate(qkv, g, dense, mask, scale, **kw):
    q, k, v = torch.from_numpy(qkv).unbind(2)
    ms = _forward_ms(qkv, dense, mask, scale)
    return split_tf32_backward(
        q, k, v, dense, None if mask is None else torch.from_numpy(mask), ms,
        torch.from_numpy(g), scale, **kw)


def _errors(got, want):
    """Each gradient's largest error over its largest magnitude."""
    return {name: float(np.abs(np.asarray(a) - np.asarray(w)).max()
                        / np.abs(np.asarray(w)).max())
            for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want)}


def _heads_reference(qkv, g, dense, mask, scale):
    """dq, dk, dv (B_, N, nh, hd) and dbias of vitta_tpu's per-(head,
    window) Pallas backward kernel, in interpret mode."""
    to3 = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(2, 0, 1, 3)))
    q, k, v = (qkv[:, :, i] for i in range(3))
    dq, dk, dv, dbias = _pallas_attn_bwd(
        to3(q), to3(k), to3(v), jnp.asarray(dense.numpy()),
        None if mask is None else jnp.asarray(mask), to3(g), scale,
        interpret=True)
    back = lambda a: np.asarray(a).transpose(1, 2, 0, 3)
    return back(dq), back(dk), back(dv), np.asarray(dbias)


def _packed_reference(qkv, g, bias, mask, scale):
    """dq, dk, dv (B_, N, nh, hd) and dbias in the bias's form from
    vitta_tpu's packed op under jax.vjp, its Pallas kernels in interpret
    mode."""
    b_, n, _, nh, hd = qkv.shape
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda a, bb: fused_window_attention_packed(a, bb, jmask, scale, nh,
                                                    interpret=True),
        jnp.asarray(qkv.reshape(b_, n, 3 * nh * hd)),
        jnp.asarray(bias.numpy()))
    dqkv, dbias = vjp(jnp.asarray(g.reshape(b_, n, nh * hd)))
    d5 = np.asarray(dqkv).reshape(b_, n, 3, nh, hd)
    return d5[:, :, 0], d5[:, :, 1], d5[:, :, 2], np.asarray(dbias)


# ----------------------------------------------------------------- tests
def test_tf32_rounding():
    """10 explicit mantissa bits, to nearest, ties away from zero; hi + lo
    holds x to 2^-21 of it."""
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11,
                      1 + 2.0 ** -11 + 2.0 ** -20, -(1 + 2.0 ** -11),
                      1 + 2.0 ** -12, 3.0e-3, -7.5e4], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10,
                         1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x)[:6], want)
    bits = tf32(torch.from_numpy(
        np.random.default_rng(0).normal(size=1000).astype(np.float32)))
    assert int((bits.view(torch.int32) & 0x1FFF).abs().max()) == 0
    hi, lo = split(x)
    assert float((((hi.double() + lo.double()) - x.double())
                  / x.double()).abs().max()) < 2.0 ** -21


@pytest.mark.parametrize("n,with_mask", [(392, True), (392, False),
                                         (75, True)])
def test_split_tf32_matches_the_heads_pallas_kernel(n, with_mask):
    qkv, g, vc, mask, wd = _inputs(n, with_mask)
    scale = 32 ** -0.5
    dense = expand_bias_reference(torch.from_numpy(vc), wd)
    dq, dk, dv, dl = _emulate(qkv, g, dense, mask, scale)
    errs = _errors((dq, dk, dv, window_sum(dl)),
                   _heads_reference(qkv, g, dense, mask, scale))
    assert max(errs.values()) <= ATTN_BWD_TOL, errs


@pytest.mark.parametrize("n,with_mask,form", [
    (392, True, "dense"), (392, True, "compact"), (75, False, "dense"),
    (75, True, "compact")])
def test_split_tf32_matches_the_packed_jax_op(n, with_mask, form):
    qkv, g, vc, mask, wd = _inputs(n, with_mask, seed=1)
    scale = 32 ** -0.5
    compact = torch.from_numpy(vc)
    dense = expand_bias_reference(compact, wd)
    dq, dk, dv, dl = _emulate(qkv, g, dense, mask, scale)
    dbias = window_sum(dl)
    if form == "compact":
        dbias = collapse_bias_reference(dbias, wd)
    want = _packed_reference(qkv, g, compact if form == "compact" else dense,
                             mask, scale)
    errs = _errors((dq, dk, dv, dbias), want)
    assert max(errs.values()) <= ATTN_BWD_TOL, errs


@pytest.mark.parametrize("blocks", [2, 4])
def test_a_problem_shared_by_blocks(blocks):
    """Swin's last stage at one or two clips: the strips dealt out to two or
    four blocks, their shares of dk and dv added in block order."""
    qkv, g, vc, mask, wd = _inputs(392, False, b_=1, nh=2, seed=2)
    scale = 32 ** -0.5
    dense = expand_bias_reference(torch.from_numpy(vc), wd)
    dq, dk, dv, dl = _emulate(qkv, g, dense, mask, scale, blocks=blocks)
    errs = _errors((dq, dk, dv, window_sum(dl)),
                   _heads_reference(qkv, g, dense, mask, scale))
    assert max(errs.values()) <= ATTN_BWD_TOL, errs
    whole = _emulate(qkv, g, dense, mask, scale)
    assert torch.equal(dq, whole[0]) and torch.equal(dl, whole[3])


def test_one_tf32_product_fails_the_tolerance():
    """The reason for the split: with one tf32 product per product (about
    three decimal digits per operand) the gradients miss 2e-5 of their
    largest magnitude by far, where the split keeps them inside it."""
    qkv, g, vc, mask, wd = _inputs(392, True, seed=3)
    scale = 32 ** -0.5
    dense = expand_bias_reference(torch.from_numpy(vc), wd)
    want = _heads_reference(qkv, g, dense, mask, scale)
    dq, dk, dv, dl = _emulate(qkv, g, dense, mask, scale, passes=1)
    single = _errors((dq, dk, dv, window_sum(dl)), want)
    dq, dk, dv, dl = _emulate(qkv, g, dense, mask, scale)
    split3 = _errors((dq, dk, dv, window_sum(dl)), want)
    assert max(split3.values()) <= ATTN_BWD_TOL, split3
    assert min(single.values()) > 10 * ATTN_BWD_TOL, single


# ------------------------------------------------------------ the forward
def _emulate_fwd(qkv, dense, mask, scale, passes=3):
    q, k, v = torch.from_numpy(qkv).unbind(2)
    return attention_forward(
        q, k, v, dense, None if mask is None else torch.from_numpy(mask),
        scale, passes)


def _fwd_heads_reference(qkv, dense, mask, scale):
    """out (B_, N, nh, hd) of vitta_tpu's per-(head, window) Pallas forward
    kernel, in interpret mode."""
    to3 = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(2, 0, 1, 3)))
    q, k, v = (qkv[:, :, i] for i in range(3))
    out = _pallas_attn_fwd(to3(q), to3(k), to3(v), jnp.asarray(dense.numpy()),
                           None if mask is None else jnp.asarray(mask), scale,
                           interpret=True)
    return np.asarray(out).transpose(1, 2, 0, 3)


def _fwd_packed_reference(qkv, bias, mask, scale):
    """out (B_, N, nh, hd) and ms (B_, N, 2nh) of vitta_tpu's packed Pallas
    forward kernel in interpret mode, the bias dense or compact."""
    b_, n, _, nh, hd = qkv.shape
    out, ms = _packed_attn_fwd(
        jnp.asarray(qkv.reshape(b_, n, 3 * nh * hd)), jnp.asarray(bias.numpy()),
        None if mask is None else jnp.asarray(mask), scale, nh, save_ms=True,
        interpret=True)
    return np.asarray(out).reshape(b_, n, nh, hd), np.asarray(ms)


def _fwd_errors(got, want):
    """Each output's largest |error| / (1 + |value|): at most ATTN_TOL where
    |error| <= ATTN_TOL + ATTN_TOL |value| everywhere, chip_smoke.py's test
    of the forward kernel against its plain version."""
    return {name: float((np.abs(np.asarray(a) - np.asarray(w))
                         / (1 + np.abs(np.asarray(w)))).max())
            for name, a, w in zip(("out", "ms"), got, want)}


@pytest.mark.parametrize("n,with_mask", [(392, True), (392, False),
                                         (75, True), (75, False)])
def test_split_tf32_forward_matches_the_heads_pallas_kernel(n, with_mask):
    """The online softmax over 32-key chunks against the per-(head, window)
    Pallas kernel (out) and the plain forward (its row maximum and sum)."""
    qkv, _g, vc, mask, wd = _inputs(n, with_mask, seed=4)
    scale = 32 ** -0.5
    dense = expand_bias_reference(torch.from_numpy(vc), wd)
    out, ms = _emulate_fwd(qkv, dense, mask, scale)
    want = (_fwd_heads_reference(qkv, dense, mask, scale),
            _forward_ms(qkv, dense, mask, scale))
    errs = _fwd_errors((out, ms), want)
    assert max(errs.values()) <= ATTN_TOL, errs


@pytest.mark.parametrize("n,with_mask,form", [
    (392, True, "dense"), (392, True, "compact"), (392, False, "compact"),
    (75, True, "dense"), (75, False, "compact")])
def test_split_tf32_forward_matches_the_packed_pallas_kernel(n, with_mask,
                                                             form):
    """out and the rows' maximum and sum against the packed Pallas kernel,
    which reads the bias dense or as its Toeplitz slices."""
    qkv, _g, vc, mask, wd = _inputs(n, with_mask, seed=5)
    scale = 32 ** -0.5
    compact = torch.from_numpy(vc)
    dense = expand_bias_reference(compact, wd)
    got = _emulate_fwd(qkv, dense, mask, scale)
    want = _fwd_packed_reference(
        qkv, compact if form == "compact" else dense, mask, scale)
    errs = _fwd_errors(got, want)
    assert max(errs.values()) <= ATTN_TOL, errs


def test_forward_with_one_tf32_product_fails_the_tolerance():
    """With one tf32 product per product, out and the rows' maximum miss
    ATTN_TOL, where the split keeps them inside it."""
    qkv, _g, vc, mask, wd = _inputs(392, True, seed=6)
    scale = 32 ** -0.5
    compact = torch.from_numpy(vc)
    dense = expand_bias_reference(compact, wd)
    want = _fwd_packed_reference(qkv, compact, mask, scale)
    split3 = _fwd_errors(_emulate_fwd(qkv, dense, mask, scale), want)
    single = _fwd_errors(_emulate_fwd(qkv, dense, mask, scale, passes=1), want)
    assert max(split3.values()) <= ATTN_TOL, split3
    assert min(single.values()) > 5 * ATTN_TOL, single


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_attention_tf32.py
    # prints each gradient's error over its largest magnitude against the
    # Pallas kernel, split TF32 and one tf32 product, at the tests' shapes,
    # then the forward's errors over 1 + |value|
    for n, with_mask, seed in ((392, True, 3), (392, False, 0), (75, True, 0)):
        qkv, g, vc, mask, wd = _inputs(n, with_mask, seed=seed)
        dense = expand_bias_reference(torch.from_numpy(vc), wd)
        want = _heads_reference(qkv, g, dense, mask, 32 ** -0.5)
        for passes in (3, 1):
            dq, dk, dv, dl = _emulate(qkv, g, dense, mask, 32 ** -0.5,
                                      passes=passes)
            errs = _errors((dq, dk, dv, window_sum(dl)), want)
            print(f"N={n} mask={with_mask} {passes} tf32 product(s): "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        for passes in (3, 1):
            errs = _fwd_errors(
                _emulate_fwd(qkv, dense, mask, 32 ** -0.5, passes=passes),
                _fwd_packed_reference(qkv, dense, mask, 32 ** -0.5))
            print(f"forward N={n} mask={with_mask} {passes} tf32 product(s): "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
