"""The split-TF32 arithmetic of the port's tensor-core kernels, emulated on
the CPU with torch (no GPU needed).

vitta_tpu_torch/csrc/tf32.cuh: every float32 operand x is hi + lo, two tf32
values (10 explicit mantissa bits; hi rounded to nearest with ties away
from zero, lo the remainder x - hi cut to 10 bits), and each k step of
eight is three mma.sync steps, lo*hi, hi*lo and hi*hi, each adding its
exact products to a float32 sum that the tensor cores cut toward zero
(``mma``).  The tf32 rounding is bit arithmetic on ``view(torch.int32)``.
Beside the primitives, the two algorithms built on them that the CPU tests
hold to the JAX package:

* ``gemm`` / ``grad_gemm``: ``gemm_tiles`` (csrc/gemm_tiles.cuh), slices
  of 32 k in k order, each slice's four k steps summed afresh and then
  added to the running sum with float32's rounding to nearest; a weight
  gradient's rows in the chunks of ``grad_plan``, their partial products
  added in chunk order.
* ``col_sums``: the bias gradient that gemm_tiles' ``EPI_PART`` takes
  beside a weight gradient, the column sums of its A over the same chunks
  and slices, written as one more row of each chunk's partial.
* ``attention_forward``: ``attn_fwd_kernel`` (csrc/attention_kernels.cuh),
  16-row query strips, keys in chunks of 32, s = q k^T summed in place over
  its k steps, o += p v in place over all keys, the online softmax (running
  maximum, sum and o rescaled per chunk), out = o / sum, and the rows'
  final maximum and sum.
"""

import math

import torch

STEP = 8             # k per mma.m16n8k8 step
STRIP = 16           # query rows per warp of the attention kernels
FWD_KEYS = 32        # keys per chunk of the attention forward
HD_PAD = 32          # head channels the attention kernels hold
GEMM_BK = 32         # k per staged slice of gemm_tiles
SM_COUNT = 132       # an H100 SXM's SMs, as grad_plan reads them
SUM_PARTS = 2        # threads on one column of EPI_PART's column sums


def tf32(x):
    """x rounded to tf32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds and the kernel's split_tf32
    computes it; the result is a float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def cut_tf32(x):
    """x cut to tf32: the 13 low mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo) as split_tf32 makes them: tf32 values with hi + lo = x to
    about 2^-21 of x."""
    hi = tf32(x)
    return hi, cut_tf32(x - hi)


def rz(x):
    """x (float64) to float32, rounded toward zero."""
    near = x.float()
    over = near.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)),
                       near)


def mma(out, a, b):
    """out + a @ b as one mma.sync step adds tf32 products to its float32
    accumulator: the products and their sum exact (float64 here), the
    result cut toward zero to float32, as the tensor cores round."""
    return rz(out.double() + a.double() @ b.double())


def mm(a, b, passes, out=None):
    """out + a @ b as mma_3xtf32 accumulates it in place: the contraction in
    steps of eight, each of the three products an mma step of its own on
    the float32 sum (``passes=3``), or one product of tf32-rounded operands
    a step."""
    if out is None:
        out = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                          + (a.shape[-2], b.shape[-1]))
    for k0 in range(0, a.shape[-1], STEP):
        ak, bk = a[..., k0:k0 + STEP], b[..., k0:k0 + STEP, :]
        if passes == 1:
            out = mma(out, tf32(ak), tf32(bk))
            continue
        ah, al = split(ak)
        bh, bl = split(bk)
        out = mma(out, al, bh)
        out = mma(out, ah, bl)
        out = mma(out, ah, bh)
    return out


def gemm(a, b, passes=3, fresh=True):
    """a (M, K) @ b (K, N) as gemm_tiles computes it over one chunk of K:
    slices of 32 k in k order (a ragged last one is zero-filled), each
    slice's four k steps summed in place (mma_3xtf32) into a fresh
    accumulator that is added to the running float32 sum, rounded to
    nearest.  ``fresh=False`` sums every k step in place in one
    accumulator instead, which the kernel does not do: the tensor cores'
    cut toward zero then piles up over all of K."""
    if not fresh:
        return mm(a, b, passes)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], GEMM_BK):
        acc = acc + mm(a[:, k0:k0 + GEMM_BK], b[k0:k0 + GEMM_BK], passes)
    return acc


def grad_plan(m, n, k):
    """(splits, kchunk) of launch_grad_gemm for out (m, n) = A^T B over k
    rows: about two blocks per SM, chunks of at least 256 rows and a
    multiple of BK."""
    tile = 128 if m >= 128 and n >= 128 else 64
    tiles = -(-m // tile) * -(-n // tile)
    want = -(-2 * SM_COUNT // tiles)
    most = max(k // 256, 1)
    want = max(1, min(want, most))
    kchunk = -(-(-(-k // want)) // GEMM_BK) * GEMM_BK
    return -(-k // kchunk), kchunk


def grad_gemm(a, b, passes=3):
    """a^T b for a (K, M), b (K, N) as launch_grad_gemm computes it: the K
    rows in grad_plan's chunks, each chunk's product as ``gemm``, the
    partial products added in chunk order (reduce_partials)."""
    k = a.shape[0]
    splits, kchunk = grad_plan(a.shape[1], b.shape[1], k)
    out = None
    for z in range(splits):
        rows = slice(z * kchunk, min(k, (z + 1) * kchunk))
        part = gemm(a[rows].t(), b[rows], passes)
        out = part if out is None else out + part
    return out


def col_sums(a, n):
    """The column sums of a (K, M) as gemm_tiles' EPI_PART computes them
    beside the weight gradient a^T b, b of n columns: the K rows in
    grad_plan's chunks; in a chunk, slices of 32 rows, each slice's rows in
    SUM_PARTS runs of 16 that as many threads add one after the other into
    a fresh float32 sum, added to that thread's running sum; the threads'
    sums added in order into the chunk's row of the partials; the chunks'
    rows added in chunk order (reduce_sums)."""
    k, m = a.shape
    splits, kchunk = grad_plan(m, n, k)
    run = GEMM_BK // SUM_PARTS
    out = torch.zeros(m)
    for z in range(splits):
        end = min(k, (z + 1) * kchunk)
        part = [torch.zeros(m) for _ in range(SUM_PARTS)]
        for s0 in range(z * kchunk, end, GEMM_BK):
            for p in range(SUM_PARTS):
                fresh = torch.zeros(m)
                for r in range(s0 + p * run, min(end, s0 + (p + 1) * run)):
                    fresh = fresh + a[r]
                part[p] = part[p] + fresh
        total = torch.zeros(m)
        for p in range(SUM_PARTS):
            total = total + part[p]
        out = out + total
    return out


def attention_forward(q, k, v, bias, mask, scale, passes=3):
    """(out (B_, N, nh, hd), ms (B_, N, 2nh)) from q, k, v (B_, N, nh, hd),
    a dense bias (nh, N, N) and a mask (nW, N, N) or None, computed as
    attn_fwd_kernel does."""
    b_, n, nh, hd = q.shape
    probs = b_ * nh
    strips = -(-n // STRIP)
    rows = strips * STRIP
    keys = -(-n // FWD_KEYS) * FWD_KEYS

    def per_problem(x, length):     # (B_, N, nh, hd) -> (P, length, HD_PAD)
        out = torch.zeros(probs, length, HD_PAD)
        out[:, :n, :hd] = x.permute(0, 2, 1, 3).reshape(probs, n, hd)
        return out

    qs = per_problem(q, rows).reshape(probs, strips, STRIP, HD_PAD)
    kp, vp = per_problem(k, keys), per_problem(v, keys)
    add = bias[None].expand(b_, nh, n, n)
    if mask is not None:
        nw = mask.shape[0]
        add = (add.reshape(b_ // nw, nw, nh, n, n)
               + mask[None, :, None]).reshape(b_, nh, n, n)
    # keys past n never count; rows past n see row n - 1's bias as the
    # kernel's clamped reads do, and are dropped
    addp = torch.full((probs, rows, keys), -math.inf)
    addp[:, :n, :n] = add.reshape(probs, n, n)
    addp[:, n:, :n] = addp[:, n - 1:n, :n]
    addp = addp.reshape(probs, strips, STRIP, keys)

    mrow = torch.full((probs, strips, STRIP), -math.inf)
    lsum = torch.zeros(probs, strips, STRIP)
    o = torch.zeros(probs, strips, STRIP, HD_PAD)
    for j0 in range(0, n, FWD_KEYS):
        kc = kp[:, None, j0:j0 + FWD_KEYS]             # (P, 1, 32, HD_PAD)
        s = mm(qs, kc.transpose(-1, -2), passes)       # (P, S, 16, 32)
        lg = s * scale + addp[..., j0:j0 + FWD_KEYS]
        mnew = torch.maximum(mrow, lg.amax(dim=-1))
        corr = torch.exp(mrow - mnew)
        p = torch.exp(lg - mnew[..., None])
        lsum = lsum * corr + p.sum(dim=-1)
        o = mm(p, vp[:, None, j0:j0 + FWD_KEYS], passes,
               out=o * corr[..., None])
        mrow = mnew
    out = (o / lsum[..., None]).reshape(probs, rows, HD_PAD)[:, :n, :hd]
    out = out.reshape(b_, nh, n, hd).permute(0, 2, 1, 3)
    ms = torch.stack([mrow, lsum], dim=-1).reshape(probs, rows, 2)[:, :n]
    ms = ms.reshape(b_, nh, n, 2).permute(0, 2, 1, 3).reshape(b_, n, 2 * nh)
    return out, ms
