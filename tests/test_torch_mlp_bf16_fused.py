"""The fused bfloat16 MLP without the LayerNorm (rows 8 and 9 bf16:
vitta_mlp_{fwd,bwd}_bf16 on csrc/mlp_fused_bf16.cuh), its plan and its
order of sums emulated in torch on the CPU, against vitta_tpu's Pallas
kernels at bfloat16 (_fwd_kernel and _bwd_kernel, vitta_tpu/ops/
pallas_mlp.py:138-183) in interpret mode, as vitta_tpu's own tests run
them.

The kernels walk tiles of 128 rows (two warpgroups of 64) over min(tiles,
SMs) persistent blocks and F = 4C in chunks of 64, one chunk at a time:
* h = x w1^T over K = C in one sum (the tensor cores' order, left to torch
  here), + b1, a and s rounded once;
* o = bfloat16(a) w2^T + b2, rounded once, summed in place over F by the
  tensor cores chunk after chunk (their order inside a chunk is their own;
  emulated as each chunk's sum added in order to the running float32 sum,
  ``chunk_product``);
* dh = (g w2) * s in float32 (over C in one sum), dhc its rounded form;
  dx = dhc w1 chunk by chunk like o; dw1 = dhc^T x and dw2 = g^T a on the
  shared core
  (``cuda_mlp.bf16_gemm_plan``'s chunks of K, each 64-deep slice summed
  afresh);
* db1: per 64 rows, each thread adds its two rows (g and g + 8 of its
  warp's 16), the eight row groups meet in a butterfly over lanes 4, 8 and
  16, the four warps are added in order (``part_dh``); db2: per 64 rows the
  rows of g one by one from 0 (``part_g``); each warpgroup adds its 64-row
  sums over its block's tiles in order from 0, and one ordered reduce adds
  the rows (block, warpgroup) in order from 0 (``block_colsums``).

Tolerances, fixed before the comparisons (those of
tests/test_torch_gemm_bf16_order.py): one bfloat16 ulp or 2^-20 of the
largest magnitude (``DIRECT``) where both sides round the same float32
value of the same rounded inputs: a, s; o from vitta_tpu's a; dhc from
vitta_tpu's s; dx and dw1 on vitta_tpu's own dhc (rebuilt outside its
kernel by its first product, which gives its dx and dw1 bit for bit); dw2;
db1; db2.  dx and dw1 from the emulated dhc pass through a rounding inside
the backward whose values may lie an ulp apart, so ``CHAINED``, 2^-12 of
the largest magnitude.  That the card's kernels add in this order is
checked on the card (tests/test_torch_cuda.py:
test_mlp_bf16_kernels_match_plain holds them within one ulp of the plain
version, two runs bit-equal).

The plan's mirror (``cuda_mlp.mlp_rows_plan``, the library's own on the
card) is checked at Swin-T's stage shapes, and the rings' protocol
(``simulate_rings``: the producer's loads in order, each slot handed back
where mf_chunk hands it back) is run to its end for every instance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_mlp import _pallas_mlp_bwd, _pallas_mlp_fwd
from vitta_tpu_torch.ops import cuda_mlp as cm
from vitta_tpu_torch.ops.cuda_mlp import bf16_gemm_plan, gelu_derivative
from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
SLICE, CHUNK = 64, 64
DIRECT = 2.0 ** -20
CHAINED = 2.0 ** -12
# Swin-T's two widths, M ragged and M large enough that the weight
# gradients' K is cut into chunks
SHAPES = [(77, 96), (1100, 96), (77, 192), (1100, 192)]


def _jbf16(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _t(a):
    arr = jnp.asarray(a)
    t = torch.from_numpy(np.asarray(arr.astype(jnp.float32)).copy())
    return t.to(BF16) if arr.dtype == jnp.bfloat16 else t


def chunk_product(a, b, chunk=CHUNK):
    """sum over k of a[:, k] b[k, :] (a (M, K), b (K, N) float32): a fresh
    sum per chunk of K, added in order to the running float32 sum."""
    run = torch.zeros(a.shape[0], b.shape[1], dtype=F32)
    for k0 in range(0, a.shape[1], chunk):
        run = run + a[:, k0:k0 + chunk] @ b[k0:k0 + chunk]
    return run


def core_product(a, b, kchunk):
    """The shared core's weight gradient: chunks of ``kchunk`` rows of K,
    each the running float32 sum of its 64-deep slices' fresh sums, then the
    chunks in order."""
    total = None
    for k0 in range(0, a.shape[1], kchunk):
        run = torch.zeros(a.shape[0], b.shape[1], dtype=F32)
        for s0 in range(k0, min(a.shape[1], k0 + kchunk), SLICE):
            run = run + a[:, s0:s0 + SLICE] @ b[s0:s0 + SLICE]
        total = run if total is None else total + run
    return total


def _blocks(x):
    """x (M, N) in blocks of 64 rows, the last padded with zeros (the
    kernels' rows past M hold zeros: TMA fills them)."""
    for b0 in range(0, x.shape[0], 64):
        blk = torch.zeros(64, x.shape[1], dtype=F32)
        rows = x[b0:b0 + 64]
        blk[:rows.shape[0]] = rows
        yield blk


def part_dh(blk):
    """db1's sum over a block of 64 rows of dh: a warp w's rows 16 w + g and
    16 w + g + 8 added by thread g, the eight g in a butterfly ((0 + 1) +
    (2 + 3)) + ((4 + 5) + (6 + 7)), the warps in order."""
    v = blk.view(4, 2, 8, -1)                      # [w][h][g]: 16 w + 8 h + g
    p = v[:, 0] + v[:, 1]
    q = p[:, 0::2] + p[:, 1::2]
    r = q[:, 0::2] + q[:, 1::2]
    w = r[:, 0] + r[:, 1]
    return ((w[0] + w[1]) + w[2]) + w[3]


def part_g(blk):
    """db2's sum over a block of 64 rows of g: the rows one by one from 0."""
    part = torch.zeros(blk.shape[1], dtype=F32)
    for r in range(64):
        part = part + blk[r]
    return part


def block_colsums(x, part, sms=132):
    """The column sums of x (M, N) float32 as the row pass and the reduce
    add them: tiles of 128 rows over grid = min(tiles, sms) blocks; the
    warpgroup w of block b adds ``part`` of its 64 rows of each of its
    tiles (b, b + grid, ...) in order from 0; the rows (b, w) in order from
    0.  Rows past M are zeros, a warpgroup wholly past M adds nothing."""
    m = x.shape[0]
    tiles = -(-m // 128)
    grid = min(tiles, sms)
    total = torch.zeros(x.shape[1], dtype=F32)
    for b in range(grid):
        for w in range(2):
            run = torch.zeros(x.shape[1], dtype=F32)
            for t in range(b, tiles, grid):
                r0 = 128 * t + 64 * w
                if r0 < m:
                    blk = torch.zeros(64, x.shape[1], dtype=F32)
                    rows = x[r0:r0 + 64]
                    blk[:rows.shape[0]] = rows
                    run = run + part(blk)
            total = total + run
    return total


def _inputs(m, c, seed):
    f = 4 * c
    rng = np.random.default_rng(seed)
    return dict(
        x=_jbf16(rng.normal(size=(m, c)) * 2 + 0.5),
        w1=_jbf16(rng.normal(size=(c, f)) / np.sqrt(c)),      # (in, out)
        b1=_jbf16(0.1 * rng.normal(size=f)),
        w2=_jbf16(rng.normal(size=(f, c)) / np.sqrt(f)),
        b2=_jbf16(0.1 * rng.normal(size=c)),
        g=_jbf16(rng.normal(size=(m, c))))


def _within(name, got, want, floor):
    want = want if isinstance(want, torch.Tensor) else _t(want)
    share, _ulps, _err = assert_bf16_within(name, got, want, floor=floor)
    print(f"{name}: {share:.2e} of values an ulp apart")


@pytest.mark.parametrize("m,c", SHAPES, ids=str)
def test_fused_order_matches_pallas(m, c):
    f = 4 * c
    assert cm.mlp_bf16_fused(c, f)
    plan = bf16_gemm_plan(m, c, f)
    if m == 1100:   # the weight gradients' K is cut into chunks
        assert plan["dw1"]["splits"] == plan["dw2"]["splits"] == 2
    p = _inputs(m, c, 13 * m + c)
    o, a, s = _pallas_mlp_fwd(p["x"], p["w1"], p["b1"], p["w2"], p["b2"],
                              True, interpret=True)
    x32 = _t(p["x"]).float()
    w1 = _t(p["w1"]).float().t()          # the port's (F, C), as float32
    w2 = _t(p["w2"]).float().t()          # (C, F)
    # the forward: h in one sum over C, o chunk by chunk from vitta's a
    h = x32 @ w1.t() + _t(p["b1"]).float()
    _within("a", torch.nn.functional.gelu(h).to(BF16), a, DIRECT)
    _within("s", gelu_derivative(h).to(BF16), s, DIRECT)
    a32, s32 = _t(a).float(), _t(s).float()
    _within("o", (chunk_product(a32, w2.t()) + _t(p["b2"]).float()).to(BF16),
            o, DIRECT)
    # the backward from vitta's residuals
    dx, dw1, dw2, db1, db2 = _pallas_mlp_bwd(p["x"], a, s, p["g"], p["w1"],
                                             p["w2"], interpret=True)
    bf, f32 = jnp.bfloat16, jnp.float32
    dot = lambda u, w, ax: jax.lax.dot_general(
        u, w, (ax, ((), ())), preferred_element_type=f32)
    dhc_j = (dot(p["g"], p["w2"], ((1,), (1,))) * s.astype(f32)).astype(bf)
    assert bool((dot(dhc_j, p["w1"], ((1,), (1,))).astype(bf) == dx).all())
    assert bool((dot(p["x"], dhc_j, ((0,), (0,))) == dw1).all())
    g32 = _t(p["g"]).float()
    dh = (g32 @ w2) * s32
    _within("dhc", dh.to(BF16), dhc_j, DIRECT)
    ch = lambda k: plan[k]["kchunk"]
    for label, dhc, tol in (("vitta_tpu's dhc", _t(dhc_j).float(), DIRECT),
                            ("the emulated dhc", dh.to(BF16).float(),
                             CHAINED)):
        _within(f"dx on {label}", chunk_product(dhc, w1).to(BF16), dx, tol)
        _within(f"dw1 on {label}",
                core_product(dhc.t(), x32, ch("dw1")).to(BF16).t(),
                dw1.astype(bf), tol)
    _within("dw2", core_product(g32.t(), a32, ch("dw2")).to(BF16).t(),
            dw2.astype(bf), DIRECT)
    # the card's 132 SMs, and 4 (several tiles a block at M = 1100)
    for sms in (132, 4):
        _within(f"db1 on {sms} SMs", block_colsums(dh, part_dh, sms).to(BF16),
                db1[0].astype(bf), DIRECT)
        _within(f"db2 on {sms} SMs", block_colsums(g32, part_g, sms).to(BF16),
                db2[0].astype(bf), DIRECT)


def test_colsum_orders_are_the_kernels_trees():
    """The two column-sum orders on values whose float32 sums depend on the
    order: each equals its tree written out term by term (two blocks of
    three tiles, the last ragged), and they differ from a plain running sum
    somewhere (so the emulation is not torch's)."""
    rng = np.random.default_rng(3)
    m = 700
    x = torch.from_numpy(rng.normal(size=(m, 5)) * 10.0 ** rng.integers(
        -4, 5, size=(m, 5))).float()
    want_dh, want_g = torch.zeros(5), torch.zeros(5)
    for b in range(2):
        for w in range(2):
            run_dh, run_g = torch.zeros(5), torch.zeros(5)
            for t in range(b, 6, 2):
                r0 = 128 * t + 64 * w
                if r0 >= m:
                    continue
                blk = torch.zeros(64, 5)
                blk[:min(64, m - r0)] = x[r0:r0 + 64]
                ws = []
                for wp in range(4):
                    p = [blk[16 * wp + g] + blk[16 * wp + g + 8]
                         for g in range(8)]
                    ws.append(((p[0] + p[1]) + (p[2] + p[3]))
                              + ((p[4] + p[5]) + (p[6] + p[7])))
                run_dh = run_dh + (((ws[0] + ws[1]) + ws[2]) + ws[3])
                seq = torch.zeros(5)
                for r in range(64):
                    seq = seq + blk[r]
                run_g = run_g + seq
            want_dh, want_g = want_dh + run_dh, want_g + run_g
    got = block_colsums(x, part_dh, sms=2)
    assert torch.equal(got, want_dh)
    assert torch.equal(block_colsums(x, part_g, sms=2), want_g)
    plain = torch.zeros(5)
    for r in range(m):
        plain = plain + x[r]
    assert not torch.equal(got, plain)


# Swin-T's stages 1 and 2 at 2 clips (the adapt pass) and 1 clip (eval)
STAGES = [(50176, 96), (12544, 192), (25088, 96), (6272, 192)]


@pytest.mark.parametrize("m,c", STAGES, ids=str)
def test_rows_plan_at_swin_t_stages(m, c):
    f = 4 * c
    plan = cm.mlp_rows_plan(m, c, f)
    assert plan["fused"] == 1 and plan["rows"] == 128
    assert plan["chunk"] == 64
    assert plan["tiles"] == -(-m // 128)
    assert plan["grid"] == min(plan["tiles"], 132)
    box, nc = 8192, -(-c // 64)
    for bwd, key in ((False, "fwd"), (True, "bwd")):
        sa, ss, sb = plan[f"{key}_a"], plan[f"{key}_s"], plan[f"{key}_b"]
        assert sa >= 2 and sb >= 2 and (ss >= 2 if bwd else ss == 0)
        # the parts: slack, x or g tiles, store buffers, column sums (per
        # warp and running), mbarriers, the rings
        parts = (1024 + 2 * nc * box + 2 * (1 if bwd else 2) * box
                 + (2 * 4 * 64 * 4 + 2 * 5 * c * 4 if bwd else 0) + 8 * 28
                 + (sa + sb) * nc * box + ss * 2 * box)
        assert plan[f"{key}_smem"] == parts <= 232448
        # one more slot in any ring would not fit
        for more in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
            if bwd or more[1] == 0:
                q = (sa + more[0], ss + more[1], sb + more[2])
                if max(q) <= cm.MF_MAX_SLOTS:
                    assert parts + (more[0] + more[2]) * nc * box \
                        + more[1] * 2 * box > 232448
    assert cm.bf16_bwd_launches(m, c, f, ln=False) == 3
    assert cm.bf16_bwd_launches(m, c, f, ln=True) >= 8


def test_other_widths_keep_the_shared_core():
    """Widths the fused kernels do not take run the core's chain: its
    plan reports none, the backward keeps its 6-8 launches."""
    for c, f in ((64, 256), (96, 320), (128, 512), (96, 192)):
        assert not cm.mlp_bf16_fused(c, f)
        assert cm.mlp_rows_plan(1100, c, f)["fused"] == 0
        assert cm.bf16_bwd_launches(1100, c, f, ln=False) in (6, 7, 8)


def simulate_rings(chunks, tiles, slots, bwd):
    """Run the rings' protocol of csrc/mlp_fused_bf16.cuh to its end or to
    a deadlock; returns True where it ends.  The producer loads, in order,
    per chunk A (the first product's weights), S (the backward's s), B (the
    second's); a load waits until its ring's slot is handed back by the
    chunk ``slots`` before it.  A warpgroup, per chunk c (mf_chunk): needs
    A(c) and hands it back; needs S(c) and hands it back; needs B(c) and
    hands it back."""
    sa, ss, sb = slots
    order = []
    for ch in range(chunks * tiles):
        order += [("A", ch)] + ([("S", ch)] if bwd else []) + [("B", ch)]
    size = {"A": sa, "S": ss, "B": sb}
    events = []
    for ch in range(chunks * tiles):
        for ring in ("A", "S", "B") if bwd else ("A", "B"):
            events += [("need", ring, ch), ("free", ring, ch)]
    freed, loaded, pos = set(), set(), 0
    for kind, ring, ch in events:
        while pos < len(order):       # the producer runs as far as it may
            r, c = order[pos]
            if c - size[r] >= 0 and (r, c - size[r]) not in freed:
                break
            loaded.add(order[pos])
            pos += 1
        if kind == "need" and (ring, ch) not in loaded:
            return False
        if kind == "free":
            freed.add((ring, ch))
    return True


@pytest.mark.parametrize("c", cm.MF_WIDTHS)
@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
def test_rings_never_deadlock(c, bwd):
    sa, ss, sb, _smem = cm.mlp_rows_smem(c, bwd)
    assert simulate_rings(4 * c // 64, 3, (sa, ss, sb), bwd)


def test_a_ring_without_slots_deadlocks():
    """The simulation bites: a ring with no slot never fills."""
    assert not simulate_rings(6, 1, (2, 0, 2), True)
