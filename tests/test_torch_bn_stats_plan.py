"""The BatchNorm-statistics kernels' plan and order of sums
(vitta_tpu_torch/csrc/bn_stats.cu), on the CPU.

``cuda_stats.bn_plan`` mirrors how the kernels cut (R, C) into blocks and
clusters (tests/test_torch_cuda.py holds it against the library's own plan
on the card).  Here it is checked for coverage and CUDA's limits at every
shape a TANet step gives the kernels and at odd sizes, and the kernels'
order of float32 additions is emulated in torch: each thread's rows in row
order (8 apart), the block's 8 warps in order, the blocks of a cluster in
rank order, then the tile's clusters in chunk order, compensated (Kahan)
in the forward.  The emulated statistics are held to the JAX package's
Pallas kernel in interpret mode and to float64 sums at the tolerances of
tests/test_torch_bn_stats.py (m rtol 1e-5 / atol 1e-6, v rtol 1e-4 / atol
1e-5), at float32 and at bfloat16 (the statistics of the rounded y, which
the Pallas kernel is handed as its x with an identity normalisation); the
emulated dscale and dbias to float64 sums of the backward's formula, within
2e-5 of their largest value (tests/test_torch_cuda.py's GRAD_REL).  Inputs
come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vitta_tpu.ops.pallas_stats import fused_bn_relu_stats as jax_fused
from vitta_tpu_torch.ops import cuda_stats
from vitta_tpu_torch.ops.cuda_stats import bn_plan

torch.set_num_threads(1)

H100_SMS = 132
# clusters of 8 blocks an H100 holds at once of an instance of the kernels
# (tools/bn_variants.py): 30 for those of two blocks an SM (both bfloat16
# ones of 8 values a thread, the float32 backward of 4), 45 and 62 for those
# of three and four (the float32 forward, the one-value path); the plan caps
# them at two blocks an SM
RESIDENT = (30, 45, 62)
MAIN_SITES = list(chip_smoke.BN_SITES)
SMALL = [(r, c) for r in (1, 37, 200) for c in (5, 30, 33)]
SHAPES = MAIN_SITES + [(int(np.prod(s[:-1])), s[-1])
                       for s, _name in chip_smoke.BN1D_SHAPES] + SMALL
GRID_X, GRID_Y, SLOT_TILES = 2 ** 31 - 1, 65535, 2048
M_TOL, V_RTOL, V_ATOL, GRAD_REL = (1e-5, 1e-6), 1e-4, 1e-5, 2e-5
cdiv = lambda a, b: -(-a // b)


def _widths(c):
    """The units a call at C may take: one value, and 4 or 8 where C is a
    multiple of them (16-byte loads of float32 or bfloat16)."""
    return [1] + [v for v in (4, 8) if c % v == 0]


@pytest.mark.parametrize("rows,c", SHAPES, ids=str)
def test_plan_covers_every_row_and_column_once(rows, c):
    for v in _widths(c):
        for resident in RESIDENT:
            p = bn_plan(rows, c, v, resident, H100_SMS)
            tiles, csize, chunk, chunks = (p[k] for k in cuda_stats.PLAN_KEYS)
            cols = [range(32 * v * j, min(32 * v * (j + 1), c))
                    for j in range(tiles)]
            assert sorted(k for r in cols for k in r) == list(range(c))
            spans = [range(i * chunk, min((i + 1) * chunk, rows))
                     for i in range(chunks)]
            assert sorted(k for r in spans for k in r) == list(range(rows))
            assert chunk % 8 == 0 and chunk >= 32
            assert csize in (1, 2, 4, 8) and chunks % csize == 0
            # blocks without rows: fewer than a cluster, all in the last
            assert chunks - cdiv(rows, chunk) < csize
            assert chunks <= GRID_X and tiles <= min(GRID_Y, SLOT_TILES)
            # one wave: every block fits at once where the tiles allow
            wave = min(8 * resident, 2 * H100_SMS)
            if tiles <= wave:
                assert chunks * tiles <= wave


@pytest.mark.parametrize("rows,c", MAIN_SITES, ids=str)
def test_main_path_sites_fill_the_card(rows, c):
    """Every site of a TANet step launches at least 1.4 blocks an SM, or a
    block for every 32 rows of each tile where its rows allow fewer, at
    float32 (4 values a thread) and at bfloat16 (8)."""
    for v in (4, 8):
        for resident in RESIDENT:
            p = bn_plan(rows, c, v, resident, H100_SMS)
            blocks = p["chunks"] * p["tiles"]
            assert blocks >= min(1.4 * H100_SMS,
                                 p["tiles"] * cdiv(rows, 32)), (v, p)
            assert blocks <= 2 * H100_SMS


def _fma(a, b, c):
    """fmaf in float32: the product and the sum in float64, rounded once
    (a product of float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _threads(a, p):
    """a (R, C) float32 as the threads see it: (chunks, chunk // 8, 8, C),
    block i's warp w taking rows i chunk + w, + w + 8, ... in order; the
    rows past R are zeros (a thread skips them, and adding 0 is exact)."""
    rows, c = a.shape
    pad = p["chunks"] * p["chunk"] - rows
    return torch.cat([a, a.new_zeros(pad, c)]).view(
        p["chunks"], p["chunk"] // 8, 8, c)


def _tree(ta, tb, p, kahan):
    """The threads' sums ta, tb (chunks, 8, C) added as the kernels add
    them: the block's warps in order, the cluster's blocks in rank order,
    then the tile's clusters in chunk order, compensated where ``kahan``."""
    c = ta.shape[-1]
    wa, wb = ta.new_zeros(ta.shape[0], c), ta.new_zeros(ta.shape[0], c)
    for w in range(8):
        wa, wb = wa + ta[:, w], wb + tb[:, w]
    wa, wb = wa.view(-1, p["csize"], c), wb.view(-1, p["csize"], c)
    ca, cb = wa.new_zeros(wa.shape[0], c), wa.new_zeros(wa.shape[0], c)
    for k in range(p["csize"]):
        ca, cb = ca + wa[:, k], cb + wb[:, k]
    s, ss, comp, comp2 = (ta.new_zeros(c) for _ in range(4))
    for q in range(ca.shape[0]):
        if kahan:
            x1 = ca[q] - comp
            t1 = s + x1
            comp, s = (t1 - s) - x1, t1
            x2 = cb[q] - comp2
            t2 = ss + x2
            comp2, ss = (t2 - ss) - x2, t2
        else:
            s, ss = s + ca[q], ss + cb[q]
    return s, ss


def emulated_stats(y, p):
    """(m, v) of the stored y (R, C) as float32, in the forward kernel's
    order: each thread adds y and y^2 (by fmaf) over its rows, the tree of
    ``_tree`` compensated, then m = s / R and v = fmaf(-m, m, ss / R)."""
    yt = _threads(y, p)
    s = yt.new_zeros(yt.shape[0], 8, yt.shape[-1])
    ss = torch.zeros_like(s)
    for k in range(yt.shape[1]):
        s, ss = s + yt[:, k], _fma(yt[:, k], yt[:, k], ss)
    s, ss = _tree(s, ss, p, kahan=True)
    inv_rows = torch.tensor(1.0 / y.shape[0], dtype=torch.float32)
    m = s * inv_rows
    return m, _fma(-m, m, ss * inv_rows)


def emulated_grads(G, xhat, p):
    """(dscale, dbias) from G and xhat (R, C) float32 in the backward
    kernel's order: each thread adds G xhat (by fmaf) and G over its rows,
    then the tree of ``_tree``, uncompensated."""
    gt, xt = _threads(G, p), _threads(xhat, p)
    ds = gt.new_zeros(gt.shape[0], 8, gt.shape[-1])
    db = torch.zeros_like(ds)
    for k in range(gt.shape[1]):
        ds, db = _fma(gt[:, k], xt[:, k], ds), db + gt[:, k]
    return _tree(ds, db, p, kahan=False)


def _inputs(rows, c, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    return dict(x=f(rng.normal(size=(rows, c)) * 2.0 + offset),
                scale=f(rng.uniform(0.5, 1.5, c)), bias=f(rng.normal(size=c)),
                mean=f(rng.normal(size=c) * 0.1),
                var=f(rng.uniform(0.5, 2.0, c)),
                g_y=f(rng.normal(size=(rows, c))), g_m=f(rng.normal(size=c)),
                g_v=f(rng.normal(size=c)))


def _stored_y(a, dtype, relu):
    """y as the kernel stores it, as float32: the plain version's, rounded
    to ``dtype``."""
    x = a["x"].to(dtype)
    y, _stats = cuda_stats.fused_bn_relu_stats_reference(
        x, a["scale"], a["bias"], a["mean"], a["var"], relu=relu)
    return x, y.float()


def _pallas_stats(a, y, dtype, relu):
    """vitta_tpu's Pallas kernel in interpret mode: at float32 on x itself,
    at bfloat16 on the rounded y under an identity normalisation (rsqrt(1
    + 0) * 1 = 1 and (y - 0) * 1 + 0 = y exactly), whose statistics are
    the ones the port's kernel takes."""
    if dtype == torch.float32:
        args = [a[k].numpy() for k in ("x", "scale", "bias", "mean", "var")]
        _jy, st = jax_fused(*(jnp.asarray(v) for v in args), relu=relu,
                            interpret=True)
    else:
        c = y.shape[1]
        one, zero = np.ones(c, np.float32), np.zeros(c, np.float32)
        _jy, st = jax_fused(jnp.asarray(y.numpy()), jnp.asarray(one),
                            jnp.asarray(zero), jnp.asarray(zero),
                            jnp.asarray(one), eps=0.0, relu=False,
                            interpret=True)
    return np.asarray(st.mean), np.asarray(st.var)


def _assert_stats(m, v, want_m, want_v, what):
    np.testing.assert_allclose(m.numpy(), want_m, rtol=M_TOL[0],
                               atol=M_TOL[1], err_msg=f"{what} mean")
    np.testing.assert_allclose(v.numpy(), want_v, rtol=V_RTOL, atol=V_ATOL,
                               err_msg=f"{what} var")


PALLAS_SHAPES = [(200, 33), (37, 30), (1, 5), (512, 32), (1568, 512),
                 (6272, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rows,c,relu", [
    (r, c, relu) for (r, c) in PALLAS_SHAPES for relu in (False, True)],
    ids=str)
def test_forward_order_matches_pallas_and_float64(rows, c, relu, dtype):
    a = _inputs(rows, c, seed=rows + c)
    _x, y = _stored_y(a, dtype, relu)
    want64 = (y.double().mean(0), y.double().square().mean(0)
              - y.double().mean(0) ** 2)
    want_p = _pallas_stats(a, y, dtype, relu)
    v_unit = 4 if dtype == torch.float32 else 8
    for v in {1, v_unit if c % v_unit == 0 else 1}:
        p = bn_plan(rows, c, v, RESIDENT[0], H100_SMS)
        m, var = emulated_stats(y, p)
        _assert_stats(m, var, *(w.numpy() for w in want64), f"{p} float64")
        _assert_stats(m, var, *want_p, f"{p} Pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rows,c", [s for s in MAIN_SITES
                                    if s not in PALLAS_SHAPES], ids=str)
def test_forward_order_at_the_main_sites(rows, c, dtype):
    """The sites with many chunks a tile: the emulated statistics against
    float64 sums of the same y."""
    a = _inputs(rows, c, seed=rows + c)
    _x, y = _stored_y(a, dtype, False)
    m64 = y.double().mean(0)
    v64 = y.double().square().mean(0) - m64 ** 2
    for resident in RESIDENT:
        p = bn_plan(rows, c, 4 if dtype == torch.float32 else 8, resident,
                    H100_SMS)
        assert p["csize"] > 1 and p["chunks"] // p["csize"] > 1
        m, v = emulated_stats(y, p)
        _assert_stats(m, v, m64.numpy(), v64.numpy(), str(p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_variance_of_an_offset_channel(dtype):
    """E[y^2] - m^2 cancels where |m| is far above the spread: the
    compensated sum over the clusters keeps v within the bound of
    tests/test_torch_cuda.py::test_bn_stats_variance_of_an_offset_channel
    (8 float32 ulps of the largest m^2, and 1e-4 of the largest v)."""
    a = _inputs(25088, 256, seed=3, offset=30.0)
    _x, y = _stored_y(a, dtype, False)
    m64 = y.double().mean(0)
    v64 = y.double().square().mean(0) - m64 ** 2
    p = bn_plan(25088, 256, 4 if dtype == torch.float32 else 8,
                RESIDENT[0], H100_SMS)
    m, v = emulated_stats(y, p)
    np.testing.assert_allclose(m.numpy(), m64.numpy(), rtol=1e-5, atol=1e-5)
    bound = (8 * torch.finfo(torch.float32).eps * float((m64 ** 2).max())
             + 1e-4 * float(v64.abs().max()))
    assert float((v.double() - v64).abs().max()) <= bound
    _jm, jv = _pallas_stats(a, y, dtype, False)
    assert float(np.abs(v.numpy() - jv).max()) <= bound


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rows,c", [(200, 33), (1568, 512), (6272, 256),
                                    (6272, 1024)], ids=str)
def test_backward_order_matches_float64(rows, c, dtype, relu):
    """dscale and dbias from the backward's G and xhat (float32, G with the
    rounded y in its v term) in the kernel's order, against float64 sums
    of the same G xhat and G."""
    a = _inputs(rows, c, seed=rows + 2 * c)
    x, y = _stored_y(a, dtype, relu)
    m = y.mean(0)
    xf = x.float()
    rstd = torch.rsqrt(a["var"] + 1e-5)
    inv = rstd * a["scale"]
    t = torch.addcmul(a["bias"] - a["mean"] * inv, xf, inv)
    G = a["g_y"].to(dtype).float() + a["g_m"] / rows \
        + a["g_v"] * 2.0 * (y - m) / rows
    if relu:
        G = G * (t > 0)
    xhat = (xf - a["mean"]) * rstd
    want = ((G.double() * xhat.double()).sum(0), G.double().sum(0))
    for resident in RESIDENT:
        p = bn_plan(rows, c, 4 if dtype == torch.float32 else 8, resident,
                    H100_SMS)
        for got, w, name in zip(emulated_grads(G, xhat, p), want,
                                ("dscale", "dbias")):
            err = float((got.double() - w).abs().max())
            assert err <= GRAD_REL * float(w.abs().max()), (name, p, err)
