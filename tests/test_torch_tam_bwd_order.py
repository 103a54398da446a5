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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_tam import _pallas_bwd, _rows
from vitta_tpu_torch.ops.cuda_tam import (bwd_plan, bwd_vec,
                                          tam_dynamic_conv_reference)

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
