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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitta_tpu.ops.pallas_ln import layer_norm_pallas
from vitta_tpu_torch.ops.cuda_ln import BWD_WARPS, ln_bwd_plan

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
