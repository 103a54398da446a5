"""The bias collapse kernel's map of blocks and threads, emulated in numpy,
against the Pallas kernel in interpret mode, bit for bit.

csrc/bias.cu makes dV (nh, 2wd-1, hw, hw) from the dense cotangent dB
(nh, N, N) with a block per (head h, in-frame row i): the block copies the
wd whole rows d1*hw + i of dB into shared memory (16 bytes a copy where
N % 4 == 0, a float otherwise; every thread walks its copies with the
kernel's running index), then its threads walk the (a, j) of dV[h, :, i, :]
the same way, each element the sum over d1 of the staged
st[d1*N + (d1 - a + wd - 1)*hw + j], added in increasing d1 as the Pallas
kernel and the plain version add.  Windows whose wd rows do not fit in
shared memory are read from dB where they lie, in the same order.  The
emulation below follows the copies and the writes as the kernel makes them
and checks that each staged element and each element of dV is written
exactly once.  It runs without a card; the kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_bias import _assemble_bwd
from vitta_tpu_torch.ops.cuda_bias import collapse_bias_reference

from test_torch_bias_rowmap import MAX_SMEM, THREADS, advance


def emulate_collapse(db, wd, max_smem=MAX_SMEM):
    """(nh, N, N) -> (nh, 2wd-1, hw, hw) as the kernel's blocks and threads
    make it (all heads at once: the map does not depend on h); returns dV
    and how often each of its elements was written."""
    nh, n, _ = db.shape
    hw = n // wd
    a_dim = 2 * wd - 1
    staged = wd * n * 4 <= max_smem
    vec = n % 4 == 0
    dv = np.full((nh, a_dim, hw, hw), np.nan, np.float32)
    writes = np.zeros((a_dim, hw, hw), np.int32)
    for i in range(hw):                      # block (i, h) for every h
        rows = db[:, i::hw, :]               # rows d1*hw + i, (nh, wd, N)
        if staged:
            st = np.full((nh, wd * n), np.nan, np.float32)
            copied = np.zeros(wd * n, np.int32)
            step = 4 if vec else 1
            for tid in range(THREADS):
                d1, q = advance(0, 0, tid, n // step)
                while d1 < wd:
                    at = d1 * n + step * q
                    st[:, at:at + step] = rows[:, d1, step * q:step * q + step]
                    copied[at:at + step] += 1
                    d1, q = advance(d1, q, THREADS, n // step)
            assert (copied == 1).all()
            src = st.reshape(nh, wd, n)
        else:
            src = rows                       # read where they lie
        for tid in range(THREADS):
            a, j = advance(0, 0, tid, hw)
            while a < a_dim:
                lo, hi = max(0, a - wd + 1), min(wd, a + 1)
                acc = src[:, lo, (lo - a + wd - 1) * hw + j].copy()
                for d1 in range(lo + 1, hi):
                    acc += src[:, d1, (d1 - a + wd - 1) * hw + j]
                dv[:, a, i, j] = acc
                writes[a, i, j] += 1
                a, j = advance(a, j, THREADS, hw)
    return dv, writes


def _cotangent(nh, window, seed=0):
    wd, wh, ww = window
    n = wd * wh * ww
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nh, n, n)).astype(np.float32)


def _pallas(db, window):
    wd, wh, ww = window
    hw = wh * ww
    (dv,) = _assemble_bwd(wd, True, (db.shape[0], 2 * wd - 1, hw, hw),
                          jnp.asarray(db))
    return np.asarray(dv)


@pytest.mark.parametrize("nh", [1, 4, 32])
@pytest.mark.parametrize("window", [(8, 7, 7), (2, 3, 3), (3, 2, 5),
                                    (4, 7, 7)], ids=str)
def test_collapse_map_matches_pallas_bit_for_bit(window, nh):
    """(8, 7, 7) and (4, 7, 7): N = 392, 196, 16-byte copies; (2, 3, 3)
    and (3, 2, 5): N = 18, 30, single floats."""
    db = _cotangent(nh, window)
    got, writes = emulate_collapse(db, window[0])
    assert (writes == 1).all()
    assert np.array_equal(got, _pallas(db, window))


@pytest.mark.parametrize("window", [(2, 3, 3), (4, 7, 7)], ids=str)
def test_collapse_map_in_place_matches_pallas(window):
    """The path for rows that do not fit in shared memory, forced here by
    allowing none."""
    db = _cotangent(3, window, seed=1)
    got, writes = emulate_collapse(db, window[0], max_smem=0)
    assert (writes == 1).all()
    assert np.array_equal(got, _pallas(db, window))
    assert np.array_equal(
        got, collapse_bias_reference(torch.from_numpy(db), window[0]).numpy())
