"""The dense-bias bfloat16 window-attention backward's blocks, its bias
gradient's order and its dq, dk and dv, against vitta_tpu, on the CPU.

The backward (csrc/attention_kernels.cuh) runs under the ``heads``,
``proj`` and ``ln_proj`` routes at bfloat16 and the packed op with a dense
bias: ``attn_bwd_bf16_kernel<kTap, false>`` writes each (window, head)'s
float32 dl to a (B_, nh, N, N) scratch, and ``launch_dense_dbias_reduce``
adds the windows in their order into dbias, 4 floats a thread
(``dbias_reduce_x4_kernel``) where nh N N is a multiple of 4, one
(``dbias_reduce_kernel``) otherwise.

* ``test_blocks_cover_every_problem_once`` replays the kernel's index
  arithmetic: a block (head, window, share z) of ``bwd_split`` shares walks
  the 16-row strips z, z + split, ..., its warps own 32 keys each, and every
  (window, head, row, key) is computed by exactly one block and warp, at
  every stage of Swin-T and Swin-B at 1 and 2 clips and at ragged windows.
  ``dense_bwd_smem`` mirrors the kernel's shared-memory layout
  (``BwdBf16Layout``, dense form): 174,720 bytes at N = 392 with the mask,
  within a block's 227 KB at every window.
* ``reduce_in_kernel_order`` replays the reduce's threads: each float of
  dbias taken by one thread, its windows added from zero in window order.
  Fed dl with negative zeros and values whose sum depends on the order, it
  gives vitta_tpu's dbias (``_dbias_accum`` into zeros, windows in grid
  order) and the plain versions' ``dbias_in_window_order`` bit for bit.
* From the dl that vitta_tpu's ``_bwd_kernel`` and ``_proj_bwd_kernel``
  add (run op by op outside pallas_call, each a jnp operation of its own,
  as the CPU tests of the bfloat16 kernels run them: XLA:CPU drops a
  rounding inside a compiled program), the reduce's order gives their
  dbias bit for bit, with and without the shift mask.
* ``kernel_dq_dk_dv`` is the kernel's order of dq, dk and dv: each warp's
  share of dq over its 32 keys, the 13 shares added in warp order; dk and
  dv over the strips in strip order (where blocks share a problem, each
  block's strips, then the blocks in order); dk times scale; each rounded
  once.  From vitta_tpu's own e, s and dl it stays within one bfloat16 ulp
  of vitta_tpu's ``_bwd_kernel`` outputs, or 2^-12 of the largest value
  where the float32 sums, taken in other orders, cancel (at most 1% of the
  values apart), with and without the mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops import pallas_attention as pa
from vitta_tpu.ops.pallas_attention import _dbias_accum
from vitta_tpu_torch.ops import cuda_attention as ca
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference

torch.set_num_threads(1)

BF16 = torch.bfloat16
SMS = 132
MAX_SPLIT = 4                # kBwdSplit
N = 392
# (model, C, heads, windows a clip) of every Swin-T and Swin-B stage
STAGES = [("swin-T", 96, 3, 64), ("swin-T", 192, 6, 16),
          ("swin-T", 384, 12, 4), ("swin-T", 768, 24, 1),
          ("swin-B", 128, 4, 64), ("swin-B", 256, 8, 16),
          ("swin-B", 512, 16, 4), ("swin-B", 1024, 32, 1)]
# (B_, N, nh) of ragged windows: N not a multiple of 16 or of 32
TINY = [(8, 18, 3), (4, 18, 6), (6, 75, 2), (2, 196, 3), (3, 7, 1),
        (1, 9, 24), (5, 98, 4), (4, 416, 2), (7, 294, 3), (2, 343, 5)]


def bwd_split(b_, nh, sms=SMS):
    """row_split(b_ nh, kBwdSplit): the blocks that share a problem."""
    return min(MAX_SPLIT, max(1, sms // (b_ * nh)))


def _coverage(n, split):
    """Every (row, key) of one problem computed by exactly one of its
    ``split`` blocks (blockIdx.z) and one warp; the grid (nh, B_, split)
    gives each (head, window, z) one block."""
    strips = -(-n // 16)
    warps = -(-n // 32)
    assert warps <= 13               # kBwdMaxWarps at N <= 416
    seen = np.zeros((n, n), np.int64)
    for z in range(split):
        for s in range(z, strips, split):
            rows = slice(16 * s, min(n, 16 * s + 16))
            for w in range(warps):
                seen[rows, 32 * w:min(n, 32 * w + 32)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("model,c,nh,windows", STAGES, ids=str)
@pytest.mark.parametrize("clips", [1, 2])
def test_blocks_cover_every_problem_once(model, c, nh, windows, clips):
    """At Swin's stages: a block a problem where the problems fill the
    card's SMs, else up to four blocks a problem, in one wave."""
    b_ = clips * windows
    split = bwd_split(b_, nh)
    _coverage(N, split)
    problems = b_ * nh
    assert split == 1 if problems >= SMS else problems * split <= SMS


@pytest.mark.parametrize("b_,n,nh", TINY, ids=str)
def test_blocks_cover_ragged_windows_once(b_, n, nh):
    for sms in (SMS, 3 * b_ * nh):
        _coverage(n, bwd_split(b_, nh, sms))


def dense_bwd_smem(n, with_mask):
    """Bytes of BwdBf16Layout(n, compact=0, ..., with_mask): K, V, the q
    and g strips twice, the warps' dl tiles, ms, the rs parts, the dq
    tiles, the strips' row table, the mask rows, the bias rows."""
    warps = -(-n // 32)
    keys = 32 * warps
    run = 4 * ((keys + 6) >> 2)                       # run_floats
    ldw = run + ((4 - run) % 16 + 16) % 16            # ld4mod16
    ldb = 32 + 8                                      # kLdB
    size = 2 * keys * ldb * 2 + 2 * (2 * 16 * ldb * 2)
    size += warps * 32 * 24 * 2                       # kDlTile bfloat16
    size += 2 * 16 * 2 * 4 + 13 * 16 * 4 + 13 * 16 * 32 * 4
    size += 16 * -(-n // 16) * 4
    size = (size + 15) & ~15                          # align16
    return size + (16 * ldw * 4 if with_mask else 0) + 16 * ldw * 4


def test_shared_memory_fits_a_block():
    """At Swin's window and every ragged one, with and without the mask,
    within a block's 227 KB (one block an SM)."""
    assert dense_bwd_smem(N, True) == 174720
    assert dense_bwd_smem(N, False) == 147840
    for n in [N] + [t[1] for t in TINY] + [416]:
        for with_mask in (False, True):
            assert dense_bwd_smem(n, with_mask) <= 232448


def reduce_in_kernel_order(dl):
    """dbias (nh, N, N) float32 as launch_dense_dbias_reduce makes it from
    dl (B_, nh, N, N) float32: a thread per 4 floats (x4) or per float,
    256 a block; each float's windows added into zero in window order,
    each float taken by exactly one thread."""
    b_, nh, n, _ = dl.shape
    outs = nh * n * n
    width = 4 if outs % 4 == 0 else 1
    threads = outs // width
    blocks = -(-threads // 256)
    idx = np.arange(blocks * 256)
    idx = idx[idx < threads]                       # the threads that add
    at = (idx[:, None] * width + np.arange(width)).reshape(-1)
    assert np.array_equal(np.sort(at), np.arange(outs))
    flat = np.asarray(dl, np.float32).reshape(b_, outs)
    acc = np.zeros(outs, np.float32)
    for b in range(b_):
        acc[at] = acc[at] + flat[b, at]
    return acc.reshape(nh, n, n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("b_,n,nh", [(6, 18, 3), (5, 75, 2), (8, 392, 2),
                                     (4, 33, 3), (2, 9, 24), (1, N, 8),
                                     (17, 18, 2), (3, N, 3), (2, N, 24),
                                     (9, 98, 4), (16, 50, 2)], ids=str)
def test_reduce_is_vitta_order(b_, n, nh):
    """Fed the same numpy dl (negative zeros among it, and values whose
    sums depend on the order), the reduce gives vitta_tpu's dbias and the
    plain versions' ``dbias_in_window_order`` bit for bit; another order
    of the same windows would not."""
    rng = np.random.default_rng(b_ * 1000 + n)
    dl = (rng.normal(size=(b_, nh, n, n))
          * np.exp(rng.normal(size=(b_, nh, n, n)) * 4)).astype(np.float32)
    dl[rng.random(dl.shape) < 0.05] = -0.0
    got = reduce_in_kernel_order(dl)
    want = np.zeros((nh, n, n), np.float32)
    for b in range(b_):
        for h in range(nh):
            _dbias_accum(want, h, 1, dl[b, h])
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(ca.dbias_in_window_order(
        torch.from_numpy(dl), torch.zeros((nh, n, n)))))
    if b_ > 2:
        assert not np.array_equal(_bits(reduce_in_kernel_order(dl[::-1])),
                                  _bits(want))


def test_reduce_kernel_named_by_width():
    assert ca.dense_dbias_reduce_kernel(N, 4) == "dbias_reduce_x4_kernel"
    assert ca.dense_dbias_reduce_kernel(33, 3) == "dbias_reduce_kernel"


class _Slot:
    """``ref[key]`` read for ``ref[key] += x``: records x and adds it."""

    def __init__(self, ref, key, value):
        self.ref, self.key, self.value = ref, key, value

    def __add__(self, other):
        self.ref.adds.append((self.key, np.asarray(other)))
        return self.value + other


class _Ref:
    """A Pallas output ref outside pallas_call: read and written by index,
    each ``ref[key] += x`` recorded in ``adds`` (key, x)."""

    def __init__(self, shape, dtype):
        self.value = jnp.zeros(shape, dtype)
        self.adds = []

    shape = property(lambda self: self.value.shape)
    dtype = property(lambda self: self.value.dtype)

    def __jax_array__(self):
        return self.value

    def __getitem__(self, key):
        return _Slot(self, key, self.value[key])

    def __setitem__(self, key, val):
        self.value = self.value.at[key].set(
            jnp.asarray(val).astype(self.value.dtype))


def _case(b_, nh, hd, window, nw, seed):
    """q, k, v (nh, B_, N, hd) bfloat16 as jnp, the dense bias and mask
    float32 as numpy, g (nh, B_, N, hd) bfloat16, scale."""
    wd, wh, ww = window
    n = wd * wh * ww
    rng = np.random.default_rng(seed)
    jb = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    q, k, v, g = (jb(rng.normal(size=(nh, b_, n, hd))) for _ in range(4))
    vc = rng.normal(size=(nh, 2 * wd - 1, wh * ww, wh * ww)) * 0.5
    bias = expand_bias_reference(torch.tensor(vc, dtype=torch.float32),
                                 wd).numpy()
    mask = None
    if nw:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
        mask[:, np.arange(n), np.arange(n)] = 0.0
        mask = mask.astype(np.float32)
    return q, k, v, g, bias, mask, hd ** -0.5


def _vitta_heads_bwd(monkeypatch, q, k, v, g, bias, mask, scale):
    """vitta_tpu's _bwd_kernel run op by op, one (head, window) at a time
    in its grid order: dq, dk, dv (nh, B_, N, hd) float32 of the bfloat16
    outputs, dbias (nh, N, N), and (B_, nh, ...) float32 of what it forms
    on the way: the dl it added into dbias (N, N), e (N, N) and the row
    sums s (N, 1) of its _softmax_parts."""
    nh, b_, n, hd = q.shape
    at = {}
    monkeypatch.setattr(pa.pl, "program_id", lambda axis: at[axis])
    outs = [np.zeros((nh, b_, n, hd), np.float32) for _ in range(3)]
    dbias = np.zeros((nh, n, n), np.float32)
    dl, e = (np.zeros((b_, nh, n, n), np.float32) for _ in range(2))
    s = np.zeros((b_, nh, n, 1), np.float32)
    for h in range(nh):
        ref = _Ref((1, n, n), jnp.float32)
        for b in range(b_):
            at[0], at[1] = h, b
            blk = (slice(h, h + 1), slice(b, b + 1))
            mb = None if mask is None else jnp.asarray(
                mask[b % mask.shape[0]][None])
            bh = jnp.asarray(bias[h][None])
            grads = [_Ref((1, 1, n, hd), jnp.bfloat16) for _ in range(3)]
            pa._bwd_kernel(q[blk], k[blk], v[blk], bh, mb, g[blk], *grads,
                           ref, scale=scale)
            for out, r in zip(outs, grads):
                out[h, b] = np.asarray(r.value[0, 0].astype(jnp.float32))
            (_key, added), = ref.adds[-1:]
            dl[b, h] = added
            eh, sh = pa._softmax_parts(pa._logits(q[blk], k[blk], bh, mb,
                                                  scale))
            e[b, h], s[b, h] = np.asarray(eh), np.asarray(sh)
        assert len(ref.adds) == b_
        dbias[h] = np.asarray(ref.value[0])
    return (*outs, dbias, dl, e, s)


def _bf16_ulp(x):
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _assert_within(name, got, want):
    """One bfloat16 ulp of |want|, or 2^-12 of the largest |want| where
    float32 sums in other orders cancel; at most 1% of the values apart."""
    gap = np.abs(got - want)
    bound = np.maximum(_bf16_ulp(want), 2.0 ** -12 * np.abs(want).max())
    assert (gap <= bound).all(), (name, (gap - bound).max())
    apart = float((gap > 0).mean())
    assert apart <= 0.01, (name, apart)
    return apart


def kernel_dq_dk_dv(q, k, e, dl, gs, scale, split=1):
    """dq, dk, dv (B_, nh, N, hd) bfloat16 in the kernel's order from float32
    q, k (B_, nh, N, hd), e and dl (B_, nh, N, N) and gs = bfloat16(g / s)
    (B_, nh, N, hd): each 16 x 8 mma tile's sum of its products taken exact
    and rounded once (the tensor cores' own order inside a tile is not
    emulated: the check allows one ulp); dq the 13 warps' shares over their
    32 keys added in warp order; dk and dv over each block's strips in
    strip order, the blocks' shares in block order; dk times scale."""
    f32, f64 = torch.float32, torch.float64
    b_, nh, n, hd = q.shape
    eb = e.to(BF16).to(f64)
    lb = dl.to(BF16).to(f64)
    dq = torch.zeros((b_, nh, n, hd), dtype=f32)
    for w in range(13):
        keys = slice(32 * w, min(n, 32 * w + 32))
        if keys.start >= n:
            share = torch.zeros_like(dq)      # a warp a short window lacks
        else:
            share = (lb[..., keys] @ k[:, :, keys].to(f64)).to(f32)
        dq = dq + share
    strips = -(-n // 16)
    dk = torch.zeros((b_, nh, n, hd), dtype=f32)
    dv = torch.zeros((b_, nh, n, hd), dtype=f32)
    for z in range(split):
        pk = torch.zeros_like(dk)
        pv = torch.zeros_like(dv)
        for s in range(z, strips, split):
            rows = slice(16 * s, min(n, 16 * s + 16))
            pk = pk + (lb[:, :, rows].transpose(-1, -2)
                       @ q[:, :, rows].to(f64)).to(f32)
            pv = pv + (eb[:, :, rows].transpose(-1, -2)
                       @ gs[:, :, rows].to(f64)).to(f32)
        dk, dv = dk + pk, dv + pv
    return ((dq * scale).to(BF16), (dk * scale).to(BF16), dv.to(BF16))


# (B_, nh, hd, window, nW): Swin's window and narrower ones, with and
# without the mask
CASES = [(8, 2, 32, (8, 7, 7), 2), (4, 3, 32, (8, 7, 7), 0),
         (8, 3, 16, (2, 3, 3), 4), (3, 2, 32, (3, 5, 5), 0)]


@pytest.mark.parametrize("b_,nh,hd,window,nw", CASES, ids=str)
def test_bwd_kernel_in_the_kernels_order_matches_vitta(monkeypatch, b_, nh,
                                                       hd, window, nw):
    q, k, v, g, bias, mask, scale = _case(b_, nh, hd, window, nw,
                                          b_ * 100 + nh)
    dq_t, dk_t, dv_t, dbias_t, dl_t, e_t, s_t = _vitta_heads_bwd(
        monkeypatch, q, k, v, g, bias, mask, scale)
    # dbias: the reduce on vitta_tpu's own dl is vitta_tpu's dbias
    assert np.array_equal(_bits(reduce_in_kernel_order(dl_t)),
                          _bits(dbias_t))
    # dq, dk, dv in the kernel's order from vitta_tpu's own e, s and dl:
    # within one ulp of its outputs, also where blocks share a problem
    heads = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                       ).permute(1, 0, 2, 3)  # (B_, nh, ..)
    tq, tk, tg = (heads(a) for a in (q, k, g))
    gs = (tg * (1.0 / torch.from_numpy(s_t))).to(BF16).to(torch.float32)
    for split in (1, 3):
        got = kernel_dq_dk_dv(tq, tk, torch.from_numpy(e_t),
                              torch.from_numpy(dl_t), gs, scale, split)
        for name, mine, theirs in zip(("dq", "dk", "dv"), got,
                                      (dq_t, dk_t, dv_t)):
            _assert_within(name, mine.permute(1, 0, 2, 3).double().numpy(),
                           theirs)


@pytest.mark.parametrize("b_", [4, 8])
def test_proj_bwd_kernel_dbias_is_the_reduces_sum(monkeypatch, b_):
    """vitta_tpu's _proj_bwd_kernel (the projection-fused chains' TPU
    kernel) run op by op, window by window, with the shift mask: from the
    dl it adds, the reduce gives its dbias bit for bit."""
    nh, hd, window, nw = 2, 32, (8, 7, 7), 2
    n = window[0] * window[1] * window[2]
    c = nh * hd
    rng = np.random.default_rng(7)
    jb = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    x = jb(rng.normal(size=(b_, n, c)))
    w = jb(rng.normal(size=(c, 3 * c)) * c ** -0.5)
    bq = jb(rng.normal(size=(1, 3 * c)) * 0.1)
    wp = jb(rng.normal(size=(c, c)) * c ** -0.5)
    g = jb(rng.normal(size=(b_, n, c)))
    _q, _k, _v, _g, bias, mask, scale = _case(b_, nh, hd, window, nw, 3)
    # the forward's o_att and ms, from vitta_tpu's own heads forward
    blocks = [(jnp.dot(x[b], w, preferred_element_type=jnp.float32).astype(
        jnp.bfloat16) + bq[0]) for b in range(b_)]
    fwd = [pa._heads_fwd(blk, jnp.asarray(bias), jnp.asarray(
        mask[b % nw][None]), jnp.bfloat16, True, scale=scale, nh=nh, hd=hd)
        for b, blk in enumerate(blocks)]
    at = {}
    monkeypatch.setattr(pa.pl, "program_id", lambda axis: at[axis])
    refs = [_Ref((b_, n, c), jnp.bfloat16), _Ref((c, 3 * c), jnp.float32),
            _Ref((1, 3 * c), jnp.float32), _Ref((c, c), jnp.float32),
            _Ref((1, c), jnp.float32), _Ref((nh, n, n), jnp.float32)]
    dbias_ref = refs[-1]
    for b in range(b_):
        at[0] = b
        o_att, ms = fwd[b]
        pa._proj_bwd_kernel(
            x[b][None], w, bq, wp, jnp.asarray(bias),
            jnp.asarray(mask[b % nw][None]), o_att[None], ms[None],
            g[b][None], _Ref((1, n, c), jnp.bfloat16), *refs[1:],
            scale=scale, nh=nh, hd=hd)
    adds = dbias_ref.adds
    assert [key for key, _ in adds] == [h for _b in range(b_)
                                        for h in range(nh)]
    dl = np.stack([a for _, a in adds]).reshape(b_, nh, n, n)
    assert np.array_equal(_bits(reduce_in_kernel_order(dl)),
                          _bits(dbias_ref.value))
