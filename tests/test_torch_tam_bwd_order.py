"""The TAM backward kernel's order of summation, emulated in float32 numpy,
against the Pallas kernel in interpret mode and the plain version's
autograd.

csrc/tam.cu cuts the backward by ``bwd_plan`` (vitta_tpu_torch/ops/
cuda_tam.py, which mirrors the kernel's ``plan_for``; the card tests hold
the two equal): T into segments, the positions into blocks of ``slots``
positions a step, each thread walking ``pp`` positions in turn.  A thread
adds its dattn value for each frame and its three dK values over its
positions and frames in that order; the block adds its slots in slot order
into one partial row per frame and three per segment; then the partial
rows of each output are added by the 32 lanes of a warp (lane l takes rows
l, l + 32, ... in turn) and the lanes in a butterfly.  The emulation below
follows that order in float32 and is held to tests/test_pallas_tam.py's
gradient tolerance (2e-4), at T from 1 to 16 (one segment or several, a
last one cut short), C = 30 (one channel a thread) and 64 (four), and a P
that is no multiple of a block's positions.

At bfloat16 with C % 8 == 0 (every TANet site) csrc/tam.cu's
tam_bwd_bf16x8_kernel cuts the work by ``bwd_plan_bf16`` instead: segments
of 4 frames, a thread taking 8 channels of ``pp`` positions in turn.  A
thread adds its dattn value of each frame over its positions (a cell a
frame, from 0) and its three dK values over its positions and frames in
that order; the block adds its slots in slot order, in B16_SLOT_PARTS
runs added in order, into one partial row a frame and three dK rows; the
block that draws the last ticket of its (n,
chunk, segment) adds the position blocks' rows in order (dattn, and the
segment's dK), and the last of the segments adds their dK rows in order.
That order is emulated below on bfloat16 values (attn and the weights
rounded, every sum float32, dx rounded once) and held to the Pallas kernel
in interpret mode at float32 on the same values, to autograd of the plain
version at bfloat16 and to float64 (GRAD_TOL), dx to the plain version's
bits; at every TANet site its plan covers every (n, position, channel,
frame) once within CUDA's limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_tam import _pallas_bwd, _rows
from vitta_tpu_torch.ops.cuda_tam import (
    B16_FRAMES, B16_SLOT_PARTS, B16_THREADS, bwd_plan, bwd_plan_bf16, bwd_vec,
    tam_dynamic_conv_backward_reference, tam_dynamic_conv_reference)

GRAD_TOL = 2e-4
F32 = np.float32
# ResNet-50's TAM sites on the adapt batch, (N, T, P, C)
TANET_SITES = [(2, 16, 3136, 64), (2, 16, 3136, 128), (2, 16, 784, 128),
               (2, 16, 784, 256), (2, 16, 196, 256), (2, 16, 196, 512),
               (2, 16, 49, 512)]


def _lane_sum(rows):
    """Rows (count, ...) added as a warp adds them: lane l takes rows l,
    l + 32, ... in turn from 0, then the lanes are added in a butterfly;
    lane 0's sum."""
    lanes = np.zeros((32,) + rows.shape[1:], F32)
    for lane in range(32):
        for j in range(lane, rows.shape[0], 32):
            lanes[lane] = lanes[lane] + rows[j]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    return lanes[0]


def emulate_bwd(g, x, attn, kern, vec=None):
    """(dx, dattn, dK) of the kernel's plan and order, float32; g and x
    (N, T, P, C), attn (N, T, C), kern (N, C, 3); ``vec`` as
    ``bwd_plan``'s."""
    n, t, p, c = x.shape
    plan = bwd_plan(n, t, p, c, vec)
    slots, pp = plan["slots"], plan["pp"]
    seg_len, nseg, npb = plan["seg_len"], plan["nseg"], plan["npb"]
    k0, k1, k2 = (kern[None, ..., k] for k in range(3))      # (1, N, C)
    gpad = np.zeros((n, t + 2, p, c), F32)
    gpad[:, 1:t + 1] = g                      # g[t] is gpad[:, t + 1]
    dx = np.full_like(x, np.nan)
    part_a = np.zeros((npb, n, t, c), F32)
    part_k = np.zeros((nseg, npb, n, 3, c), F32)
    for seg in range(nseg):
        t0 = seg * seg_len
        t1 = min(t, t0 + seg_len)
        for pb in range(npb):
            # a block: its slots side by side, (slot, N, C) per row
            cells = np.zeros((t1 - t0, slots, n, c), F32)
            dk = np.zeros((3, slots, n, c), F32)
            for m in range(pp):
                pos = (pb * pp + m) * slots + np.arange(slots)
                ok = pos < p
                if not ok.any():
                    break
                pv = pos[ok]
                for tt in range(t0, t1):
                    gn, gc, gm = (gpad[:, tt + d][:, pv].transpose(1, 0, 2)
                                  for d in (2, 1, 0))
                    xt = x[:, tt][:, pv].transpose(1, 0, 2)
                    at = attn[:, tt][None]
                    dy = k0 * gn + k1 * gc + k2 * gm
                    dx[:, tt, pv] = (at * dy).transpose(1, 0, 2)
                    q = dy * xt
                    cells[tt - t0, ok] = q if m == 0 else cells[tt - t0, ok] + q
                    y = at * xt
                    for k, gk in enumerate((gn, gc, gm)):
                        dk[k, ok] = dk[k, ok] + gk * y
            s_a, s_k = cells[:, 0], dk[:, 0]          # slots in slot order
            for y in range(1, slots):
                s_a, s_k = s_a + cells[:, y], s_k + dk[:, y]
            part_a[pb, :, t0:t1] = s_a.transpose(1, 0, 2)
            part_k[seg, pb] = s_k.transpose(1, 0, 2)
    dattn = _lane_sum(part_a)
    dkern = _lane_sum(part_k.reshape(nseg * npb, n, 3, c)).transpose(0, 2, 1)
    return dx, dattn, dkern


def _inputs(n, t, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, h, w, c)).astype(F32)
    attn = (1.0 / (1.0 + np.exp(-rng.normal(size=(n, t, c))))).astype(F32)
    logits = rng.normal(size=(n, c, 3))
    kern = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(F32)
    g = rng.normal(size=x.shape).astype(F32)
    return x, attn, kern, g


def _check_order(t, c, vec=None):
    n, h, w = 2, 7, 5                 # P = 35: blocks of 32 positions
    x, attn, kern, g = _inputs(n, t, h, w, c, seed=t * 100 + c)
    plan = bwd_plan(n, t, h * w, c, vec)
    assert (h * w) % (plan["slots"] * plan["pp"]) != 0
    got = emulate_bwd(g.reshape(n, t, h * w, c), x.reshape(n, t, h * w, c),
                      attn, kern, vec)
    got = (got[0].reshape(x.shape),) + got[1:]

    a_row, k_rows = _rows(jnp.asarray(attn), jnp.asarray(kern), w)
    dx2, da, dk = _pallas_bwd(jnp.asarray(g.reshape(n, t, h, w * c)),
                              jnp.asarray(x.reshape(n, t, h, w * c)), a_row,
                              k_rows, interpret=True)
    pallas = (np.asarray(dx2).reshape(x.shape),
              np.asarray(da).reshape(n, t, w, c).sum(2),
              np.asarray(dk).reshape(n, 3, w, c).sum(2).transpose(0, 2, 1))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, attn, kern)]
    out = tam_dynamic_conv_reference(*leaves)
    plain = torch.autograd.grad(out, leaves, torch.tensor(g))
    for name, mine, pal, pl in zip(("dx", "dattn", "dkernel"), got, pallas,
                                   plain):
        np.testing.assert_allclose(mine, pal, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{name} against Pallas")
        np.testing.assert_allclose(mine, pl.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"{name} against "
                                   "autograd")


@pytest.mark.parametrize("c", [30, 64])
@pytest.mark.parametrize("t", [1, 2, 3, 9, 16])
def test_order_matches_pallas_and_autograd(t, c):
    _check_order(t, c)


@pytest.mark.parametrize("t", [1, 9, 16])
def test_order_of_the_one_channel_path_at_c64(t):
    """C % 4 == 0 but inputs not 16-byte aligned: one channel a thread,
    four times the units and channel chunks of the 16-byte path."""
    _check_order(t, 64, vec=0)


def test_unaligned_views_take_the_one_channel_path():
    """``bwd_vec``: 16-byte units only where C % 4 == 0 and every tensor
    starts on a 16-byte boundary."""
    x = torch.zeros(2, 3, 4, 64)
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    assert shifted.is_contiguous()
    assert bwd_vec(64, x, x) == 1
    assert bwd_vec(64, x, shifted) == 0
    assert bwd_vec(30, x) == 0
    assert bwd_plan(2, 16, 196, 256, 0)["units"] == 256


@pytest.mark.parametrize("site", TANET_SITES, ids=str)
def test_plan_at_the_tanet_sites(site):
    """Each block sums at least 32 positions, so the partial rows (one per
    frame and position block, three per segment and position block) stay
    a few percent of x's size; no segment is longer than 16 frames."""
    n, t, p, c = site
    plan = bwd_plan(n, t, p, c)
    assert plan["vec"] == 1 and plan["slots"] * plan["pp"] >= 32
    assert plan["seg_len"] <= 16 and plan["nseg"] * plan["seg_len"] >= t
    rows = plan["npb"] * (t + 3 * plan["nseg"])
    assert rows / (p * t) < 0.08


# ---------------------------------------------------------------- bfloat16


def _bf16(a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


def emulate_bwd_bf16(g, x, attn, kern, sms):
    """(dx before its rounding, dattn, dK) of tam_bwd_bf16x8_kernel's plan
    and order, float32; g and x (N, T, P, C) of bfloat16 values, attn (N, T,
    C) and kern (N, C, 3) float32, rounded here as the kernel rounds
    them."""
    n, t, p, c = x.shape
    plan = bwd_plan_bf16(n, t, p, c, sms)
    slots, pp, nseg, npb = (plan[k] for k in ("slots", "pp", "nseg", "npb"))
    attn, kern = _bf16(attn), _bf16(kern)
    k0, k1, k2 = (kern[None, ..., k] for k in range(3))      # (1, N, C)
    gpad = np.zeros((n, t + 2, p, c), F32)
    gpad[:, 1:t + 1] = g                      # g[t] is gpad[:, t + 1]
    dx = np.full_like(x, np.nan)
    seen = np.zeros((n, t, p), np.int32)
    dattn = np.zeros((n, t, c), F32)
    dk_segs = []
    for seg in range(nseg):
        t0 = seg * B16_FRAMES
        t1 = min(t, t0 + B16_FRAMES)
        part_a = np.zeros((npb, t1 - t0, n, c), F32)
        part_k = np.zeros((npb, 3, n, c), F32)
        for pb in range(npb):
            cells = np.zeros((t1 - t0, slots, n, c), F32)   # from 0
            dk = np.zeros((3, slots, n, c), F32)
            for m in range(pp):
                pos = (pb * pp + m) * slots + np.arange(slots)
                ok = pos < p
                if not ok.any():
                    break
                pv = pos[ok]
                seen[:, t0:t1, pv] += 1
                for tt in range(t0, t1):
                    gn, gc, gm = (gpad[:, tt + d][:, pv].transpose(1, 0, 2)
                                  for d in (2, 1, 0))
                    xt = x[:, tt][:, pv].transpose(1, 0, 2)
                    at = attn[:, tt][None]
                    dy = k0 * gn + k1 * gc + k2 * gm
                    dx[:, tt, pv] = (at * dy).transpose(1, 0, 2)
                    cells[tt - t0, ok] = cells[tt - t0, ok] + dy * xt
                    y = at * xt
                    for k, gk in enumerate((gn, gc, gm)):
                        dk[k, ok] = dk[k, ok] + gk * y
            # slots in slot order, in runs of sp added in order
            sp = -(-slots // B16_SLOT_PARTS)
            s_a, s_k = np.zeros_like(cells[:, 0]), np.zeros_like(dk[:, 0])
            for q in range(B16_SLOT_PARTS):
                r_a, r_k = np.zeros_like(s_a), np.zeros_like(s_k)
                for y in range(q * sp, min((q + 1) * sp, slots)):
                    r_a, r_k = r_a + cells[:, y], r_k + dk[:, y]
                s_a, s_k = s_a + r_a, s_k + r_k
            part_a[pb], part_k[pb] = s_a, s_k
        # the last block of (n, chunk, segment): position blocks in order
        s_a, s_k = np.zeros_like(part_a[0]), np.zeros_like(part_k[0])
        for pb in range(npb):
            s_a, s_k = s_a + part_a[pb], s_k + part_k[pb]
        dattn[:, t0:t1] = s_a.transpose(1, 0, 2)
        dk_segs.append(s_k)
    assert (seen == 1).all()
    dkern = np.zeros_like(dk_segs[0])       # the segments in order
    for s_k in dk_segs:
        dkern = dkern + s_k
    return dx, dattn, dkern.transpose(1, 2, 0)


# (T, C, sms): one segment cut short, several, the last cut short; one
# chunk of units (C 24: three units; 64), several (C 256: two chunks of 16);
# cards small enough that threads walk several positions
B16_CASES = [(1, 64, 132), (3, 24, 2), (9, 64, 4), (16, 64, 1),
             (5, 256, 3), (16, 136, 8)]


@pytest.mark.parametrize("t,c,sms", B16_CASES, ids=str)
def test_bf16_order_matches_pallas_autograd_and_float64(t, c, sms):
    n, h, w = 2, 7, 5                 # P = 35
    x, attn, kern, g = _inputs(n, t, h, w, c, seed=t * 100 + c)
    x, g = _bf16(x), _bf16(g)
    p = h * w
    got = emulate_bwd_bf16(g.reshape(n, t, p, c), x.reshape(n, t, p, c),
                           attn, kern, sms)
    got = (got[0].reshape(x.shape),) + got[1:]
    ar, kr = _bf16(attn), _bf16(kern)      # what the kernel reads

    a_row, k_rows = _rows(jnp.asarray(ar), jnp.asarray(kr), w)
    dx2, da, dk = _pallas_bwd(jnp.asarray(g.reshape(n, t, h, w * c)),
                              jnp.asarray(x.reshape(n, t, h, w * c)), a_row,
                              k_rows, interpret=True)
    pallas = (np.asarray(dx2).reshape(x.shape),
              np.asarray(da).reshape(n, t, w, c).sum(2),
              np.asarray(dk).reshape(n, 3, w, c).sum(2).transpose(0, 2, 1))
    # the plain version at bfloat16 (its gradients are those of the rounded
    # attn and weights), and float64 on the same rounded values
    plain = tam_dynamic_conv_backward_reference(
        *(torch.tensor(v).to(torch.bfloat16) for v in (g, x)),
        torch.tensor(attn),
        torch.tensor(kern))
    x64, g64 = x.astype(np.float64), g.astype(np.float64)
    a64, k64 = ar.astype(np.float64), kr.astype(np.float64)
    gp = np.pad(g64, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
    dy = (k64[:, None, None, None, :, 0] * gp[:, 2:]
          + k64[:, None, None, None, :, 1] * gp[:, 1:t + 1]
          + k64[:, None, None, None, :, 2] * gp[:, :t])
    y64 = a64[:, :, None, None, :] * x64
    exact = (a64[:, :, None, None, :] * dy, (dy * x64).sum((2, 3)),
             np.stack([(gp[:, 2 - j:2 - j + t] * y64).sum((1, 2, 3))
                       for j in range(3)], -1))
    for name, mine, pal, e in zip(("dx", "dattn", "dkernel"), got, pallas,
                                  exact):
        np.testing.assert_allclose(mine, pal, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{name} against Pallas")
        np.testing.assert_allclose(mine, e, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{name} against float64")
    assert np.array_equal(_bf16(got[0]), plain[0].float().numpy())
    for name, mine, pl in zip(("dattn", "dkernel"), got[1:], plain[1:]):
        np.testing.assert_allclose(mine, pl.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"{name} plain")


def test_bf16_units_need_16_byte_alignment():
    """``bwd_vec`` at bfloat16: 8-channel units only where C % 8 == 0 and
    every tensor starts on a 16-byte boundary (a view 2, 4 or 8 bytes past
    one takes one channel a thread); at float32 4-channel units as
    before."""
    x = torch.zeros(2, 3, 4, 64, dtype=torch.bfloat16)
    attn = torch.zeros(2, 3, 64)
    for shift in (1, 2, 4):
        off = torch.zeros(x.numel() + shift, dtype=torch.bfloat16)[shift:]
        assert bwd_vec(64, x, off.view(x.shape), attn) == 0
    assert bwd_vec(64, x, x, attn) == 1
    assert bwd_vec(60, x[..., :60].contiguous(), attn[..., :60]) == 0
    assert bwd_vec(64, attn, attn) == 1


@pytest.mark.parametrize("site", TANET_SITES + [(1, 16, 3136, 64),
                                                (1, 16, 49, 512),
                                                (2, 3, 196, 256)], ids=str)
@pytest.mark.parametrize("sms", [132, 114])
def test_bf16_plan_at_the_tanet_sites(site, sms):
    """At every TANet site (the adapt batch, one clip, three frames), on
    132 and 114 SMs: every (n, position, unit, frame) taken by one thread
    once, a block of at most 256 threads, a grid of at most two blocks an
    SM within CUDA's limits, the block's shared memory within 113 KB (two
    blocks an SM), the tickets within a slot, and the partial rows a small
    share of x."""
    n, t, p, c = site
    plan = bwd_plan_bf16(n, t, p, c, sms)
    units, wc, slots, pp, nseg, npb, ncc = (plan[k] for k in (
        "units", "wc", "slots", "pp", "nseg", "npb", "ncc"))
    assert units == c // 8 and wc * slots <= B16_THREADS
    assert ncc * wc >= units > (ncc - 1) * wc
    assert nseg * B16_FRAMES >= t > (nseg - 1) * B16_FRAMES
    taken = np.zeros(p, np.int32)
    for pb in range(npb):
        for m in range(pp):
            pos = (pb * pp + m) * slots + np.arange(slots)
            taken[pos[pos < p]] += 1
    assert (taken == 1).all()
    assert plan["blocks"] == n * ncc * nseg * npb
    assert plan["blocks"] <= max(2 * sms, n * ncc * nseg) < 2 ** 31 - 1
    smem = (7 * wc * (slots + B16_SLOT_PARTS) * 8 + 4 * wc * 8 + wc * 24) * 4
    assert 2 * smem <= 227 * 1024
    assert n * ncc * (nseg + 1) <= 2048
    rows = npb * 7 * nseg + 3 * nseg           # a chunk's partial rows
    assert rows * 8 * wc / (t * p * 8 * wc) < 0.25
