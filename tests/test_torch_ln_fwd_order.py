"""The bfloat16 LayerNorm forward kernel's plan and order of summation,
emulated in float32 numpy, against the Pallas kernel in interpret mode.

csrc/ln_rows.cuh's ln_fwd_bf16x8 takes every C % 8 == 0 up to 2048 in
16-byte units of 8 values, cut by ``ln_fwd_bf16_plan``
(vitta_tpu_torch/ops/cuda_ln.py mirrors the kernel's; the card tests hold
the two equal): a row is ``lanes`` lanes of one warp, each holding
``units`` units (units lane, lane + lanes, ...); a row's sum and sum of
squares are each lane's over its units and their 8 values in order, then a
butterfly over the row's lanes (offsets lanes / 2 down to 1; a row never
spans warps, so no warps are added after it).  Then mu = s1 / C, rstd =
rsqrt(s2 / C - mu^2 + eps) and y = (x - mu) * rstd * gamma + beta in
float32, rounded once to bfloat16.  Block b takes the contiguous rows [b *
chunk, ...), its row groups at step s the ``batch`` rows from r0 + (s *
groups + g) * batch.

The emulation is held to vitta_tpu.ops.pallas_ln._ln_fwd in interpret mode
on the same values: at bfloat16 y within one bfloat16 ulp (or 2^-20 of the
largest |y|, where a value near 0 is the difference of larger terms), and at
float32 within LN_TOL (2e-5, the test_torch_swin_backward.py tolerance of
the same one-pass formula summed in another order), at C = 8, 24 (units
masked past the row), 96, 128, 192, 256 (two rows at once), 384, 512, 768,
1024, 1536 and 2048 (32 lanes of 6 and 8 units), row counts that are no
multiple of a block's rows (the last block's rows run out) and a single
row, on grids of one step a block and of several.  At every Swin-B and
Swin-T site at 1 and 2 clips the plan covers every row and column once
within CUDA's limits, and every plan up to C = 2048 names an instance the
source compiles.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from vitta_tpu.ops.pallas_ln import _ln_fwd
from vitta_tpu_torch.ops import cuda_ln
from vitta_tpu_torch.ops.cuda_ln import F16_THREADS, ln_fwd_bf16_plan
from vitta_tpu_torch.tools.ln_bias_sites import (SWIN_LN_SITES,
                                                 SWIN_T_LN_SITES)

LN_TOL = 2e-5
F32 = np.float32
EPS = 1e-5
LN_ROWS = (Path(cuda_ln.__file__).resolve().parent.parent / "csrc"
           / "ln_rows.cuh")


def _bf16(a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


def _row_sums(v, plan, c):
    """Sums over each row of v (R, C) in the kernel's order: each lane over
    its units and their 8 values in order (a unit past the row adds
    nothing), then a butterfly over the row's lanes."""
    lanes, units, n = plan["lanes"], plan["units"], c // 8
    per = v.reshape(v.shape[0], n, 8)
    acc = np.zeros((v.shape[0], lanes), F32)
    for i in range(units):
        u = np.arange(lanes) + lanes * i
        blk = np.where((u < n)[None, :, None], per[:, np.minimum(u, n - 1)],
                       F32(0))
        for j in range(8):
            acc = acc + blk[:, :, j]
    o = lanes // 2
    while o:
        acc = acc + acc[:, np.arange(lanes) ^ o]
        o //= 2
    return acc[:, 0]


def _visits(plan, rows):
    """How many times the plan's blocks, steps, row groups and batches
    reach each row."""
    seen = np.zeros(rows, np.int64)
    groups, batch = F16_THREADS // plan["lanes"], plan["batch"]
    chunk = plan["chunk"]
    for blk in range(plan["blocks"]):
        r0, r1 = blk * chunk, min((blk + 1) * chunk, rows)
        steps = -(-(r1 - r0) // (groups * batch))
        for s in range(steps):
            for g in range(groups):
                for b in range(batch):
                    r = r0 + (s * groups + g) * batch + b
                    if r < r1:
                        seen[r] += 1
    return seen


def emulate_ln_fwd_bf16(x, gamma, beta, per_sm, sms):
    """y before its rounding, in float32, of ln_fwd_bf16x8's plan and
    order on x holding bfloat16 values."""
    rows, c = x.shape
    plan = ln_fwd_bf16_plan(rows, c, per_sm, sms)
    assert (_visits(plan, rows) == 1).all()
    inv_c = F32(1.0) / F32(c)
    mu = _row_sums(x, plan, c) * inv_c
    var = _row_sums(x * x, plan, c) * inv_c - mu * mu + F32(EPS)
    rstd = (F32(1.0) / np.sqrt(var)).astype(F32)
    return ((x - mu[:, None]) * rstd[:, None] * gamma + beta).astype(F32)


def _inputs(rows, c, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(rows, c)) * 2 + 0.5)
    g = rng.normal(size=c).astype(F32)
    b = rng.normal(size=c).astype(F32)
    return x, g, b


def _ulp_within(name, got, want):
    """|got - want| within one bfloat16 ulp of |want|, or 2^-20 of the
    largest |want|."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    tol = np.maximum(ulp, 2.0 ** -20 * np.abs(want).max())
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{name}: {int(bad.sum())} values beyond one ulp"


# (rows, C, per_sm, sms): every lanes / units the plan takes at C = 8 to
# 2048, grids of one step a block (4 blocks an SM of 132) and of several
# steps a block (one block an SM of 1 or 2), rows no multiple of a block's
# rows, a single row
ORDER_CASES = [(37, 8, 4, 132), (50, 24, 1, 2), (520, 96, 4, 132),
               (600, 128, 1, 2), (333, 192, 4, 132), (777, 256, 1, 1),
               (300, 384, 4, 132), (130, 512, 1, 2), (50, 768, 4, 132),
               (70, 1024, 1, 1), (40, 1536, 4, 132), (33, 2048, 1, 2),
               (1, 128, 4, 132), (1, 2048, 4, 132)]


@pytest.mark.parametrize("rows,c,per_sm,sms", ORDER_CASES, ids=str)
def test_ln_fwd_bf16_order_matches_pallas(rows, c, per_sm, sms):
    x, g, b = _inputs(rows, c, seed=rows + c)
    got = emulate_ln_fwd_bf16(x, g, b, per_sm, sms)
    want = np.asarray(_ln_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                              EPS, interpret=True))
    np.testing.assert_allclose(got, want, rtol=LN_TOL, atol=LN_TOL,
                               err_msg="y at float32")
    yb = _ln_fwd(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g),
                 jnp.asarray(b), EPS, interpret=True)
    _ulp_within("y at bfloat16", _bf16(got),
                np.asarray(yb.astype(jnp.float32)))


SWIN_SITES = sorted({(k * t, c) for t, c in (*SWIN_LN_SITES,
                                             *SWIN_T_LN_SITES)
                     for k in (1, 2)})


@pytest.mark.parametrize("rows,c", SWIN_SITES, ids=str)
@pytest.mark.parametrize("per_sm", [2, 4, 8])
def test_ln_fwd_bf16_plan_at_the_swin_sites(rows, c, per_sm):
    """At every Swin-B and Swin-T LayerNorm site at 1 and 2 clips, on an
    H100's 132 SMs and however many blocks an SM holds: every row in one
    block, one step and one row group's batch; units of 8 values exactly
    filling the row's lanes of one warp (C = 8 units lanes, no masked
    unit), at most 3 units a lane below 32 lanes and 8 at 32, at most 8
    units of x in flight a thread (4 registers each), two rows at once
    where C <= 256; a grid of one wave unless a block takes a single step,
    within CUDA's limits; gamma and beta's shared memory within the 48 KB
    a launch takes without an attribute."""
    plan = ln_fwd_bf16_plan(rows, c, per_sm, 132)
    lanes, units, batch = plan["lanes"], plan["units"], plan["batch"]
    assert lanes in (4, 8, 16, 32) and 8 * units * lanes == c
    assert units <= (8 if lanes == 32 else 3)
    assert batch * units * 4 <= 32
    assert batch == (2 if c <= 256 else 1)
    cols = (np.arange(lanes)[:, None] + lanes * np.arange(units)).ravel()
    assert sorted(cols.tolist()) == list(range(c // 8))
    step = F16_THREADS // lanes * batch
    blocks, chunk = plan["blocks"], plan["chunk"]
    assert chunk >= step and (blocks - 1) * chunk < rows <= blocks * chunk
    assert blocks <= per_sm * 132 or chunk == step
    assert blocks < 2 ** 31 - 1
    assert (_visits(plan, rows) == 1).all()
    assert 2 * c * 4 <= 48 * 1024


def test_ln_fwd_bf16_plan_refuses_what_the_kernel_does():
    for rows, c in ((0, 128), (8, 100), (8, 2056), (8, 0), (8, -8)):
        with pytest.raises(ValueError):
            ln_fwd_bf16_plan(rows, c, 4, 132)


def test_ln_fwd_bf16_plans_name_compiled_instances():
    """Every plan for C % 8 == 0 up to 2048 names a (units, lanes) instance
    of VITTA_LN_F16_INSTANCES in csrc/ln_rows.cuh, and the mirror's
    constants are the source's."""
    src = LN_ROWS.read_text()
    body = src[src.index("#define VITTA_LN_F16_INSTANCES(X)"):]
    body = body[:body.index("\n\n")]
    instances = {(int(u), int(lanes))
                 for u, lanes in re.findall(r"X\((\d+), (\d+)\)", body)}
    planned = set()
    for c in range(8, 2049, 8):
        plan = ln_fwd_bf16_plan(1000, c, 4, 132)
        planned.add((plan["units"], plan["lanes"]))
    assert planned == instances
    consts = dict(re.findall(r"constexpr int (kLnF16\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "kLnF16Threads": cuda_ln.F16_THREADS,
        "kLnF16MaxUnits": cuda_ln.F16_MAX_UNITS,
        "kLnF16MaxLanes": cuda_ln.F16_MAX_LANES,
        "kLnF16MaxC": cuda_ln.F16_MAX_C,
        "kLnF16BatchC": cuda_ln.F16_BATCH_C,
        "kLnF16Batch": cuda_ln.F16_BATCH}
