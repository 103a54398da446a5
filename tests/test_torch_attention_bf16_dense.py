"""The dense-bias bfloat16 window-attention forward's plan and order of
sums, against vitta_tpu's heads forward, on the CPU.

The kernel (csrc/attention_kernels.cuh, attn_fwd_dense_bf16_kernel) runs
under the ``heads``, ``proj`` and ``ln_proj`` routes at bfloat16 and the
packed op with a dense bias.  A block takes ``slots`` 16-row strips of one
head (strips b, b + bands, ... of band b), four warps a strip, and walks a
run of windows, those that share a mask next to each other; the strip's
16-key steps are dealt to its warps in turns (step st to warp st mod 4).
Each warp walks its steps twice, the row maxima first, then e = exp(l - m),
its sum and bfloat16(e) v, and the four warps' partial sums and o are
added in warp order.

* ``cuda_attention.dense_fwd_bf16_plan`` mirrors ``dense_fwd_plan``, which
  the card's library exports (``vitta_attn_dense_fwd_bf16_plan``;
  tests/test_torch_cuda.py holds the two equal on the card).  At every
  stage of Swin-T and Swin-B, whose attention shapes the three routes share,
  at 1 and 2 clips: shared memory within a block's 227 KB, the grid at
  least the card's 132 SMs, the strips and windows covered once, runs of
  whole mask groups; the tiny test windows likewise (ragged n, no mask,
  n % 4 != 0 taking the 4-byte copies).
* ``block_cover`` replays the kernel's index arithmetic and shows that
  every (window, head, row, 16-key step) is computed by exactly one warp,
  so nothing is written twice and nothing depends on the blocks' order.
* ``kernel_row_sums`` is the kernel's order of s in torch: lane t of a
  warp adds its keys 16 st + 8 hf + 2 t + c in that order, the quad's four
  lanes are added pairs first, the warps' sums in warp order.  A loop over
  single floats gives the same bits.  Fed e from vitta_tpu's heads forward
  run op by op at bfloat16 (``_logits``, ``_softmax_parts``, outside jit),
  that s stays within 2^-21 of vitta_tpu's own sum, and out =
  bfloat16((bfloat16(e) v) / s) within one bfloat16 ulp of vitta_tpu's out,
  or 2^-12 of its largest value where the product's float32 sums, taken in
  other orders, cancel (at most 1% of the values apart), with and without
  the shift mask; so does it from the port's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import (_fwd_kernel, _logits,
                                            _softmax_parts)
from vitta_tpu_torch.ops import cuda_attention as ca
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference

torch.set_num_threads(1)

BF16 = torch.bfloat16
SMS = 132
SMEM_PER_BLOCK = 232448
SPLIT = 4                    # warps a strip (kDenseSplit)
WINDOW = (8, 7, 7)
N = 392
# (model, C, heads, tokens per clip, windows per clip) of every stage
STAGES = [("swin-T", 96, 3, 25088, 64), ("swin-T", 192, 6, 6272, 16),
          ("swin-T", 384, 12, 1568, 4), ("swin-T", 768, 24, 392, 1),
          ("swin-B", 128, 4, 25088, 64), ("swin-B", 256, 8, 6272, 16),
          ("swin-B", 512, 16, 1568, 4), ("swin-B", 1024, 32, 392, 1)]
# (b_, n, nh, nw) of the tests' windows: Swin's (2, 3, 3) and (3, 5, 5)
# windows, ragged n, no mask, nw dividing b_
TINY = [(8, 18, 3, 4), (4, 18, 6, 0), (6, 75, 2, 3), (2, 196, 3, 2),
        (3, 7, 1, 0), (4, 98, 6, 2), (2, 416, 4, 0), (5, 33, 2, 5)]


def _stage_cases():
    cases = []
    for model, c, nh, tokens, windows in STAGES:
        for clips in (1, 2):
            b_ = clips * tokens // N
            for nw in ((0, windows) if windows > 1 else (0,)):
                cases.append((model, b_, nh, nw))
    return cases


def _check_plan(p, b_, n, nh, nw, vec):
    strips = -(-n // 16)
    assert p["strips"] == strips and p["keys"] == 16 * strips
    assert p["ldb"] >= p["keys"] and p["ldb"] % 16 == 8     # banks
    assert p["smem"] <= SMEM_PER_BLOCK
    assert p["slots"] * SPLIT <= 16
    # bands cover the strips, none empty
    assert p["slots"] * p["bands"] >= strips
    assert (p["slots"] - 1) * p["bands"] < strips
    # runs of whole mask groups cover the windows, none empty
    group = b_ // nw if nw else 1
    assert p["run"] % group == 0
    assert p["run"] * p["runs"] >= b_ > (p["runs"] - 1) * p["run"]
    assert p["blocks"] == nh * p["bands"] * p["runs"]
    assert p["vec"] == int(vec)


@pytest.mark.parametrize("model,b_,nh,nw", _stage_cases(), ids=str)
def test_plan_at_swin_stages(model, b_, nh, nw):
    p = ca.dense_fwd_bf16_plan(b_, N, nh, nw, True, SMS)
    _check_plan(p, b_, N, nh, nw, True)
    # the grid fills the card, four strips a block
    assert p["blocks"] >= SMS, p
    assert (p["strips"], p["keys"], p["ldb"], p["slots"], p["bands"],
            p["smem"]) == (25, 400, 408, 4, 7, 230400), p


def test_plan_at_swin_t_stage_1():
    """Swin-T's first stage at 2 clips: 128 windows, 64 masks; runs of 2
    mask groups (4 windows) with the mask, 5 windows without."""
    with_mask = ca.dense_fwd_bf16_plan(128, N, 3, 64, True, SMS)
    assert (with_mask["run"], with_mask["runs"], with_mask["blocks"]) == (
        4, 32, 672)
    plain = ca.dense_fwd_bf16_plan(128, N, 3, 0, True, SMS)
    assert (plain["run"], plain["runs"], plain["blocks"]) == (5, 26, 546)


@pytest.mark.parametrize("b_,n,nh,nw", TINY, ids=str)
def test_plan_at_tiny_windows(b_, n, nh, nw):
    vec = n % 4 == 0
    p = ca.dense_fwd_bf16_plan(b_, n, nh, nw, vec, SMS)
    _check_plan(p, b_, n, nh, nw, vec)
    # bands of at most four strips, three at N = 416, filled evenly
    assert p["bands"] == -(-p["strips"] // (4 if n < 416 else 3)), p


def block_cover(b_, n, nh, nw, plan):
    """How often the kernel's blocks compute each (window, head, strip,
    16-key step): the block index -> (head, band, run) split, the strip of
    warp group ``slot`` and its warps' steps, the run's window order
    (``(o mod group) nw + o // group``, its mask ``o // group``).  Returns
    the counts (b_, nh, strips, steps) and, per block, the masks of its
    windows in the order it takes them."""
    strips, steps = plan["strips"], plan["keys"] // 16
    count = np.zeros((b_, nh, strips, steps), np.int64)
    group = b_ // nw if nw else 1
    masks = []
    for blk in range(plan["blocks"]):
        h, unit = blk % nh, blk // nh
        band, run = unit % plan["bands"], unit // plan["bands"]
        o0, o1 = run * plan["run"], min(b_, (run + 1) * plan["run"])
        order = []
        for o in range(o0, o1):
            b = (o % group) * nw + o // group if nw else o
            if nw:
                assert b % nw == o // group
                order.append(o // group)
            for slot in range(plan["slots"]):
                s = band + plan["bands"] * slot
                if s >= strips:
                    continue
                for part in range(SPLIT):
                    for st in range(part, steps, SPLIT):
                        count[b, h, s, st] += 1
        masks.append(order)
    return count, masks


@pytest.mark.parametrize("b_,n,nh,nw", [(128, N, 3, 64), (128, N, 4, 0),
                                        (8, N, 12, 4), (2, N, 32, 0)]
                         + TINY, ids=str)
def test_blocks_cover_every_problem_once(b_, n, nh, nw):
    plan = ca.dense_fwd_bf16_plan(b_, n, nh, nw, n % 4 == 0, SMS)
    count, masks = block_cover(b_, n, nh, nw, plan)
    assert (count == 1).all()
    # a block meets each of its masks in one stretch: staged once a group
    for order in masks:
        changes = sum(1 for x, y in zip(order, order[1:]) if x != y)
        assert changes == max(len(set(order)) - 1, 0), order


def kernel_row_sums(e, split=SPLIT):
    """s (..., N) float32 of e (..., N, N) float32 in the kernel's order:
    warp w of a strip takes the 16-key steps st = w, w + split, ...; lane t
    adds its keys 16 st + 8 hf + 2 t + c in (st, hf, c) order from 0; the
    quad's lanes are added (t0 + t1) + (t2 + t3); the warps' sums in warp
    order from 0.  Keys past N count as e = 0, which adds nothing."""
    n = e.shape[-1]
    keys = 16 * -(-n // 16)
    ep = torch.zeros(e.shape[:-1] + (keys,), dtype=torch.float32)
    ep[..., :n] = e
    steps = ep.reshape(e.shape[:-1] + (keys // 16, 2, 4, 2))   # st, hf, t, c
    total = torch.zeros(e.shape[:-1], dtype=torch.float32)
    for w in range(split):
        lane = torch.zeros(e.shape[:-1] + (4,), dtype=torch.float32)
        for st in range(w, keys // 16, split):
            for hf in range(2):
                for c in range(2):
                    lane = lane + steps[..., st, hf, :, c]
        quad = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
        total = total + quad
    return total


def _row_sums_one_by_one(row, split=SPLIT):
    """The same order on one row, one float32 addition at a time."""
    n = row.shape[0]
    keys = 16 * -(-n // 16)
    f = np.float32
    total = f(0.0)
    for w in range(split):
        lanes = []
        for t in range(4):
            acc = f(0.0)
            for st in range(w, keys // 16, split):
                for hf in range(2):
                    for c in range(2):
                        j = 16 * st + 8 * hf + 2 * t + c
                        acc = f(acc + (row[j] if j < n else f(0.0)))
            lanes.append(acc)
        total = f(total + f(f(lanes[0] + lanes[1]) + f(lanes[2] + lanes[3])))
    return total


@pytest.mark.parametrize("n", [18, 75, 392])
def test_row_sums_are_the_kernels_order(n):
    rng = np.random.default_rng(n)
    e = np.exp(rng.normal(size=(5, n)) * 3).astype(np.float32)
    got = kernel_row_sums(torch.from_numpy(e))
    want = np.array([_row_sums_one_by_one(r) for r in e], np.float32)
    assert np.array_equal(got.numpy(), want)
    # another order gives other bits somewhere: the test can tell
    other = kernel_row_sums(torch.from_numpy(e), split=1)
    if n == 392:
        assert not torch.equal(other, got)


class _Out:
    """What vitta_tpu's kernel writes to its bfloat16 output block."""

    dtype = jnp.bfloat16

    def __setitem__(self, key, value):
        self.value = value


def _vitta_heads_fwd(q3, k3, v3, bias, mask, scale):
    """vitta_tpu's heads forward (_fwd_kernel) run op by op, one (head,
    window) at a time: out (nh, B_, N, hd) bfloat16, and its e and s."""
    nh, b_ = q3.shape[:2]
    outs, es, ss = [], [], []
    for h in range(nh):
        for b in range(b_):
            blk = (slice(h, h + 1), slice(b, b + 1))
            mb = None if mask is None else mask[b % mask.shape[0]][None]
            o = _Out()
            _fwd_kernel(q3[blk], k3[blk], v3[blk], bias[h][None], mb, o,
                        scale=scale)
            e, s = _softmax_parts(_logits(q3[blk], k3[blk], bias[h][None], mb,
                                          scale))
            outs.append(np.asarray(o.value.astype(jnp.float32)))
            es.append(np.asarray(e))
            ss.append(np.asarray(s)[:, 0])
    shape = (nh, b_) + outs[0].shape
    return (np.stack(outs).reshape(shape),
            np.stack(es).reshape((nh, b_) + es[0].shape),
            np.stack(ss).reshape((nh, b_) + ss[0].shape))


def _bf16_ulp(x):
    """One bfloat16 ulp of |x| (float64), the smallest normal's at 0."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _assert_within(got, want):
    """|got - want| within one bfloat16 ulp of |want| or 2^-12 of the
    largest |want| (the floor of tests/test_torch_bf16_swin_kernels.py
    behind an inner rounding: here bfloat16(e) before the product, whose
    float32 sums the two sides take in other orders), at most 1% of the
    values apart at all; returns that share."""
    gap = np.abs(got - want)
    bound = np.maximum(_bf16_ulp(want), 2.0 ** -12 * np.abs(want).max())
    assert (gap <= bound).all(), (gap - bound).max()
    apart = float((gap > 0).mean())
    assert apart <= 0.01, apart
    return apart


# (B_, nh, hd, window, nW): Swin-T's heads and hd, with and without the mask
ORDER_CASES = [(4, 3, 32, (2, 3, 3), 2), (2, 3, 16, (3, 5, 5), 0),
               (2, 2, 32, (4, 7, 7), 2), (2, 1, 32, (8, 7, 7), 0)]


@pytest.mark.parametrize("b_,nh,hd,window,nw", ORDER_CASES, ids=str)
def test_out_in_the_kernels_order_matches_vitta(b_, nh, hd, window, nw):
    wd, wh, ww = window
    n = wd * wh * ww
    rng = np.random.default_rng(b_ * 100 + n)
    jb = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    qkv = jb(rng.normal(size=(nh, 3, b_, n, hd)))
    vc = rng.normal(size=(nh, 2 * wd - 1, wh * ww, wh * ww)) * 0.5
    bias = expand_bias_reference(torch.tensor(vc, dtype=torch.float32),
                                 wd).numpy()
    mask = None
    if nw:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
        mask[:, np.arange(n), np.arange(n)] = 0.0
        mask = mask.astype(np.float32)
    scale = hd ** -0.5
    q3, k3, v3 = (qkv[:, i] for i in range(3))
    out_tpu, e, s_tpu = _vitta_heads_fwd(
        q3, k3, v3, jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask).astype(jnp.bfloat16),
        scale)
    s = kernel_row_sums(torch.from_numpy(e))
    # the order's float32 s against vitta_tpu's sum of the same e
    rel = np.abs(s.numpy().astype(np.float64) - s_tpu) / s_tpu
    assert rel.max() <= 2.0 ** -21, rel.max()
    # out = bfloat16((bfloat16(e) v) / s), the product's float32 sums exact
    v = torch.from_numpy(np.array(v3.astype(jnp.float32))).double()
    eb = torch.from_numpy(e).to(BF16).double()
    o = torch.einsum("hbqk,hbkd->hbqd", eb, v).float()
    out = (o / s[..., None]).to(BF16).double().numpy()
    apart = _assert_within(out, out_tpu)
    # and the port's plain version, from the packed views
    tq, tk, tv = (torch.from_numpy(np.asarray(t.astype(jnp.float32))).to(
        BF16).permute(1, 2, 0, 3) for t in (q3, k3, v3))
    plain = ca.heads_attention_bf16_reference(
        tq, tk, tv, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), scale)
    _assert_within(out, plain.permute(2, 0, 1, 3).double().numpy())
    print(f"n={n} mask={nw}: s within {rel.max():.2e} of vitta_tpu's; out "
          f"{apart:.2e} of values an ulp or more from vitta_tpu's")
