"""The LayerNorm backward kernel's plan and order of summation, emulated in
float32 numpy, against the Pallas kernel's VJP in interpret mode.

csrc/ln_rows.cuh cuts the rows by ``ln_bwd_plan`` (vitta_tpu_torch/ops/
cuda_ln.py, which mirrors the kernel's; the card tests hold the two equal):
block b takes the contiguous rows [b * rows_per_block, ...), its 16 warps
form groups of ``wpr`` warps a row, and at step s group g takes ``batch``
rows from r0 + (s * groups + g) * batch.  A thread of a group owns the same
units (float4 or single floats) of every row; a row's sums are the
threads' sums over their units, a butterfly over a warp's lanes, then the
group's warps in order.  Each thread adds dy * xh and dy for its columns
over its group's rows in the order it takes them; the block adds its groups
in group order into one partial (2, C), and the partials are added in block
order.  The emulation below follows that order in float32 and is held to
tests/test_torch_swin_backward.py's LN_TOL (2e-5) at C = 96, 128, 192 and
2048 (one warp a row, several rows at once; four warps a row), a C that is
no multiple of 4 (single floats; at 4090 sixteen warps a row), rows that
are no multiple of a block's rows, and a single row.

At bfloat16 with C % 8 == 0 (every Video Swin site) csrc/ln.cu's
ln_bwd_bf16x8 cuts the rows by ``ln_bwd_bf16_plan`` instead: a row is
``lanes`` lanes holding ``units`` 16-byte units each (units lane, lane +
lanes, ...), a block's 256 threads are row groups taking rows r0 + s *
groups + g, and the row's sums are each lane's over its units, a butterfly
over the row's lanes of a warp and the row's warps in order.  A lane adds
dy * xh and dy over its group's rows; the groups of a warp are added in a
butterfly (lane offsets 16 down to lanes), the warps (or, at more than 32
lanes a row, the groups) in order, the blocks of a cluster in rank order,
and the clusters in order by the blocks that draw the last tickets.  That
order is emulated below on bfloat16 inputs (x, dy and dx's rounding
bfloat16, every sum float32) and held to the Pallas kernel in interpret
mode at float32 on the same values and to float64 at LN_TOL, its dx
rounded to bfloat16 within one bfloat16 ulp of the Pallas kernel's at
bfloat16; at every Swin-B and Swin-T site its plan covers every row and
column once within CUDA's limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from vitta_tpu.ops.pallas_ln import layer_norm_pallas
from vitta_tpu_torch.ops.cuda_ln import (B16_THREADS, BWD_WARPS,
                                         ln_bwd_bf16_plan, ln_bwd_plan)
from vitta_tpu_torch.tools.ln_bias_sites import (SWIN_LN_SITES,
                                                 SWIN_T_LN_SITES)

LN_TOL = 2e-5
F32 = np.float32


def _owned(plan, c):
    """(columns, mask) of shape (32 * wpr, units * w): the columns a thread
    of a group owns, unit by unit (units t, t + 32 * wpr, ...), and which of
    them exist."""
    w = 4 if plan["vec"] else 1
    threads = 32 * plan["wpr"]
    units = (np.arange(threads)[:, None]
             + threads * np.arange(plan["units"])[None, :])
    cols = (units[..., None] * w + np.arange(w)).reshape(threads, -1)
    return np.minimum(cols, c - 1), cols < c


def _row_sums(v, plan, cols, mask):
    """Sums over each row of v (R, C) as the kernel takes them: each thread
    over its units in order, a butterfly over the 32 lanes of each warp, the
    warps of the group in order."""
    per = np.where(mask, v[:, cols], F32(0))          # (R, threads, k)
    acc = np.zeros(per.shape[:2], F32)
    for k in range(per.shape[2]):
        acc = acc + per[:, :, k]
    lanes = acc.reshape(v.shape[0], plan["wpr"], 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, np.arange(32) ^ o]
    total = lanes[:, 0, 0]
    for k in range(1, plan["wpr"]):
        total = total + lanes[:, k, 0]
    return total


def emulate_ln_bwd(x, gamma, dy, eps, vec):
    """(dx, dgamma, dbeta) of the kernel's plan and order, float32."""
    rows, c = x.shape
    plan = ln_bwd_plan(rows, c, vec)
    cols, mask = _owned(plan, c)
    inv_c = F32(1.0) / F32(c)
    mu = _row_sums(x, plan, cols, mask) * inv_c
    rstd = (1.0 / np.sqrt(_row_sums(x * x, plan, cols, mask) * inv_c
                          - mu * mu + F32(eps))).astype(F32)
    xh = (x - mu[:, None]) * rstd[:, None]
    wg = dy * gamma
    a = _row_sums(wg, plan, cols, mask) * inv_c
    b = _row_sums(wg * xh, plan, cols, mask) * inv_c
    dx = rstd[:, None] * (wg - a[:, None] - xh * b[:, None])
    groups, batch = BWD_WARPS // plan["wpr"], plan["batch"]
    rpb = plan["rows_per_block"]
    seen = np.zeros(rows, np.int32)
    partials = []
    for blk in range(plan["blocks"]):
        r0, r1 = blk * rpb, min((blk + 1) * rpb, rows)
        acc = np.zeros((groups, 2, c), F32)       # every thread's sums
        steps = -(-(r1 - r0) // (groups * batch))
        for s in range(steps):
            for g in range(groups):
                for r in range(r0 + (s * groups + g) * batch,
                               r0 + (s * groups + g + 1) * batch):
                    if r < r1:
                        acc[g, 0] = acc[g, 0] + dy[r] * xh[r]
                        acc[g, 1] = acc[g, 1] + dy[r]
                        seen[r] += 1
        part = acc[0]
        for g in range(1, groups):
            part = part + acc[g]
        partials.append(part)
    assert (seen == 1).all()
    dgb = partials[0]
    for p in partials[1:]:
        dgb = dgb + p
    return dx, dgb[0], dgb[1]


def _inputs(rows, c, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, c)) * 2 + 0.5).astype(F32)
    g = rng.normal(size=c).astype(F32)
    b = rng.normal(size=c).astype(F32)
    dy = rng.normal(size=(rows, c)).astype(F32)
    return x, g, b, dy


@pytest.mark.parametrize("rows,c,vec", [
    (600, 128, 1),     # one warp a row, 4 rows at once
    (520, 96, 1),      # 24 units a row: lanes 24-31 masked
    (333, 192, 1),     # 2 units a lane, 2 rows at once
    (3000, 128, 1),    # 131 blocks of 23 rows, the last of 10
    (70, 2048, 1),     # four warps a row
    (200, 96, 0),      # single floats where the pointers are unaligned
    (37, 50, 0),       # C % 4 != 0
    (20, 4090, 0),     # single floats, sixteen warps a row
    (1, 128, 1),       # a single row
], ids=str)
def test_ln_bwd_order_matches_pallas(rows, c, vec):
    x, g, b, dy = _inputs(rows, c)
    got = emulate_ln_bwd(x, g, dy, 1e-5, vec)
    _, vjp = jax.vjp(lambda *a: layer_norm_pallas(*a, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, np.asarray(w), rtol=LN_TOL,
                                   atol=LN_TOL, err_msg=name)


@pytest.mark.parametrize("rows,c", [(50176, 128), (12544, 256),
                                    (3136, 512), (784, 2048), (50176, 96),
                                    (784, 1536), (3000, 50), (1, 8),
                                    (10, 4090)])
def test_ln_bwd_plan_covers_rows_and_columns(rows, c):
    """At Swin's sites and beside them: every row in one block, at most 132
    blocks, partials (2, C) a block no more than an eighth of the
    activation once a block has 16 rows, every column owned once by a
    group, a lane holding at most 16 floats of a row (8 single floats), and
    the block's sums over its groups fitting its 32 KB of shared memory."""
    for vec in ((1, 0) if c % 4 == 0 else (0,)):
        plan = ln_bwd_plan(rows, c, vec)
        rpb, blocks = plan["rows_per_block"], plan["blocks"]
        assert (blocks - 1) * rpb < rows <= blocks * rpb <= rows + rpb - 1
        assert blocks <= 132
        if rows >= 16 * 132:
            assert 2 * blocks * c <= rows * c / 8
        w = 4 if vec else 1
        cols, mask = _owned(plan, c)
        assert sorted(cols[mask].tolist()) == list(range(c))
        assert plan["units"] * w <= (16 if vec else 8)
        assert plan["batch"] * plan["units"] * w <= 16
        assert BWD_WARPS // plan["wpr"] * c <= 8192


def test_ln_bwd_plan_refuses_what_the_kernel_does():
    for rows, c, vec in ((0, 128, 1), (8, 4100, 0), (8, 50, 1)):
        with pytest.raises(ValueError):
            ln_bwd_plan(rows, c, vec)


# ---------------------------------------------------------------- bfloat16


def _bf16(a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


def _b16_row_sums(v, plan, c, mask_units=True):
    """Sums over each row of v (R, C) as ln_bwd_bf16x8 takes them: each
    lane over its units (lane, lane + lanes, ...) and their 8 values in
    order, a butterfly over the row's lanes of a warp, the row's warps in
    order."""
    lanes, units, n = plan["lanes"], plan["units"], c // 8
    rows = v.shape[0]
    per = v.reshape(rows, n, 8)
    acc = np.zeros((rows, lanes), F32)
    for i in range(units):
        u = np.arange(lanes) + lanes * i
        blk = np.where((u < n)[None, :, None], per[:, np.minimum(u, n - 1)],
                       F32(0))
        for j in range(8):
            acc = acc + blk[:, :, j]
    rl = min(lanes, 32)
    warps = acc.reshape(rows, lanes // rl, rl)
    o = rl // 2
    while o:
        warps = warps + warps[:, :, np.arange(rl) ^ o]
        o //= 2
    total = warps[:, 0, 0]
    for k in range(1, lanes // rl):
        total = total + warps[:, k, 0]
    return total


def emulate_ln_bwd_bf16(x, gamma, dy, eps, resident, sms):
    """(dx before its rounding, dgamma, dbeta) of ln_bwd_bf16x8's plan and
    order, float32, on x and dy holding bfloat16 values."""
    rows, c = x.shape
    plan = ln_bwd_bf16_plan(rows, c, resident, sms)
    inv_c = F32(1.0) / F32(c)
    mu = _b16_row_sums(x, plan, c) * inv_c
    rstd = (1.0 / np.sqrt(_b16_row_sums(x * x, plan, c) * inv_c - mu * mu
                          + F32(eps))).astype(F32)
    xh = (x - mu[:, None]) * rstd[:, None]
    wg = dy * gamma
    a = _b16_row_sums(wg, plan, c) * inv_c
    b = _b16_row_sums(wg * xh, plan, c) * inv_c
    dx = rstd[:, None] * (wg - a[:, None] - xh * b[:, None])
    lanes, chunk, csize = plan["lanes"], plan["chunk"], plan["csize"]
    groups = B16_THREADS // lanes
    terms = np.concatenate([dy * xh, dy], axis=1)        # (R, 2C)
    seen = np.zeros(rows, np.int32)
    parts = []
    for blk in range(plan["blocks"]):
        r0, r1 = blk * chunk, min((blk + 1) * chunk, rows)
        acc = np.zeros((groups, 2 * c), F32)    # each group's lane sums
        for s in range(-(-max(r1 - r0, 0) // groups)):
            r = r0 + s * groups + np.arange(groups)
            ok = r < r1
            acc[ok] = acc[ok] + terms[r[ok]]
            seen[r[ok]] += 1
        if lanes < 32:                # a warp's groups in a butterfly
            per = 32 // lanes
            owners = acc.reshape(groups // per, per, 2 * c)
            o = per // 2
            while o:
                owners = owners + owners[:, np.arange(per) ^ o]
                o //= 2
            owners = owners[:, 0]
        else:
            owners = acc
        part = owners[0]
        for k in range(1, owners.shape[0]):
            part = part + owners[k]
        parts.append(part)
    assert (seen == 1).all()
    total = np.zeros(2 * c, F32)
    for q in range(plan["blocks"] // csize):    # clusters, ranks in order
        cluster = parts[q * csize]
        for k in range(1, csize):
            cluster = cluster + parts[q * csize + k]
        total = total + cluster
    return dx, total[:c], total[c:]


def _ulp_within(name, got, want):
    """|got - want| within one bfloat16 ulp of |want|, or 2^-20 of the
    largest |want| (a value near 0 is a difference of larger float32
    terms)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    tol = np.maximum(ulp, 2.0 ** -20 * np.abs(want).max())
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{name}: {int(bad.sum())} values beyond one ulp"


# (rows, C, resident, sms): lanes 4 (C 32: two units, 96: three; 40:
# masked units), 8, 16, 32, 64 (1024, 1536) and 128 (2048); several clusters
# of 8 and of fewer (small cards), single blocks, rows no multiple of a
# block's rows, a single row
B16_CASES = [(600, 128, 1, 4), (520, 96, 2, 6), (333, 192, 1, 3),
             (777, 256, 2, 8), (300, 512, 4, 16), (50, 768, 1, 4),
             (70, 1024, 1, 2), (40, 1536, 2, 8), (33, 2048, 1, 6),
             (37, 40, 1, 4), (300, 32, 1, 1), (1, 8, 33, 132)]


@pytest.mark.parametrize("rows,c,resident,sms", B16_CASES, ids=str)
def test_ln_bwd_bf16_order_matches_pallas(rows, c, resident, sms):
    x, g, b, dy = _inputs(rows, c, seed=rows + c)
    x, dy = _bf16(x), _bf16(dy)
    got = emulate_ln_bwd_bf16(x, g, dy, 1e-5, resident, sms)
    _, vjp = jax.vjp(lambda *a: layer_norm_pallas(*a, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    x64, g64, dy64 = (v.astype(np.float64) for v in (x, g, dy))
    mu = x64.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt((x64 * x64).mean(-1, keepdims=True) - mu * mu
                         + 1e-5)
    xh = (x64 - mu) * rstd
    wg = dy64 * g64
    exact = (rstd * (wg - wg.mean(-1, keepdims=True)
                     - xh * (wg * xh).mean(-1, keepdims=True)),
             (dy64 * xh).sum(0), dy64.sum(0))
    for name, a, w, e in zip(("dx", "dgamma", "dbeta"), got, want, exact):
        np.testing.assert_allclose(a, np.asarray(w), rtol=LN_TOL,
                                   atol=LN_TOL, err_msg=f"{name} Pallas")
        np.testing.assert_allclose(a, e, rtol=LN_TOL, atol=LN_TOL,
                                   err_msg=f"{name} float64")
    # dx rounded once, against the Pallas kernel at bfloat16
    xb, dyb = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, dy))
    _, vjp = jax.vjp(lambda *a: layer_norm_pallas(*a, 1e-5, True),
                     xb, jnp.asarray(g), jnp.asarray(b))
    dxb = np.asarray(vjp(dyb)[0].astype(jnp.float32))
    _ulp_within("dx bfloat16", _bf16(got[0]), dxb)


SWIN_SITES = sorted({(2 * t, c) for t, c in (*SWIN_LN_SITES,
                                             *SWIN_T_LN_SITES)})


@pytest.mark.parametrize("rows,c", SWIN_SITES, ids=str)
@pytest.mark.parametrize("resident", [8, 16, 33])
def test_ln_bwd_bf16_plan_at_the_swin_sites(rows, c, resident):
    """At every Swin-B and Swin-T LayerNorm site of the adapt batch (2
    clips), on an H100's 132 SMs and whatever clusters of 8 the card holds
    of the instance: every row in one block and one row group's step, every
    column in one lane's units, units of 8 values exactly filling the row's
    lanes (C = 8 units lanes, no masked unit), at most 3 units a lane, a
    grid of one wave within CUDA's limits whose blocks come in whole
    clusters of at most 8, at least a row a row group, the instance's
    shared memory within 113 KB (two blocks an SM), and the clusters' partials (2, C) no more
    than a tenth of the activation."""
    plan = ln_bwd_bf16_plan(rows, c, resident, 132)
    lanes, units = plan["lanes"], plan["units"]
    groups = B16_THREADS // lanes
    assert lanes in (4, 8, 16, 32, 64, 128) and 1 <= units <= 3
    assert 8 * units * lanes == c
    cols = (np.arange(lanes)[:, None] + lanes * np.arange(units)).ravel()
    assert sorted(cols.tolist()) == list(range(c // 8))
    blocks, chunk, csize = plan["blocks"], plan["chunk"], plan["csize"]
    assert csize in (1, 2, 4, 8) and blocks % csize == 0
    assert blocks <= min(resident * 8, 2 * 132) < 2 ** 31 - 1
    assert chunk >= groups
    assert (blocks - csize) * chunk < rows <= blocks * chunk
    owners = 8 if lanes < 32 else groups
    assert (5 + 2 * owners) * (8 * lanes * units) * 4 <= 113 * 1024
    assert blocks // csize * 2 * c <= rows * c / 10


def test_ln_bwd_bf16_plan_refuses_what_the_kernel_does():
    for rows, c in ((0, 128), (8, 100), (8, 2056), (8, 0)):
        with pytest.raises(ValueError):
            ln_bwd_bf16_plan(rows, c, 33, 132)
