"""The bias expansion kernel's map of blocks and threads, emulated in numpy,
against the Pallas kernel in interpret mode, bit for bit.

csrc/bias.cu writes the dense (nh, N, N) bias with a block per (head h,
in-frame row i): the block stages the 2wd-1 source rows V[h, :, i, :] in
shared memory in reverse order of the displacement a (four copies, copy s
shifted by s floats, where N % 4 == 0; one otherwise), and its threads then
copy the runs of N floats that are the rows d1*hw + i, 16 bytes a move from
the copy in which the run starts aligned, else a float at a time; windows
whose copies do not fit in shared memory are read from V where they lie.
The emulation below follows every thread's moves as the kernel makes them
(``advance`` is the kernel's running index) and checks that each element of
the output is written exactly once.  It runs without a card; the kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_bias import _assemble
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference

THREADS = 128            # csrc/bias.cu: kThreads
MAX_SMEM = 227 * 1024    # csrc/bias.cu: kMaxSmem


def advance(seg, off, step, length):
    """csrc/bias.cu's ``advance``: a running (segment, offset) pair."""
    off += step
    while off >= length:
        off -= length
        seg += 1
    return seg, off


def emulate_expand(v, wd, max_smem=MAX_SMEM):
    """(nh, 2wd-1, hw, hw) -> (nh, N, N) as the kernel's blocks and threads
    write it (all heads at once: the map does not depend on h); returns the
    output and how often each element was written."""
    nh, a_dim, hw, _ = v.shape
    n = wd * hw
    length = a_dim * hw
    pitch = (length + 3) & ~3
    vec = n % 4 == 0
    staged = (4 * pitch if vec else length) * 4 <= max_smem
    out = np.full((nh, n, n), np.nan, np.float32)
    writes = np.zeros((n, n), np.int32)
    for i in range(hw):                      # block (i, h) for every h
        if not staged:
            for d1 in range(wd):
                for tid in range(THREADS):
                    d2, j = advance(0, 0, tid, hw)
                    while d2 < wd:
                        out[:, d1 * hw + i, d2 * hw + j] = \
                            v[:, d1 - d2 + wd - 1, i, j]
                        writes[d1 * hw + i, d2 * hw + j] += 1
                        d2, j = advance(d2, j, THREADS, hw)
            continue
        st = np.full((nh, 4 * pitch if vec else length), np.nan, np.float32)
        for b in range(a_dim):               # the staging, warp b, lanes j
            src = v[:, a_dim - 1 - b, i, :]
            k = b * hw + np.arange(hw)
            if vec:
                for s in range(4):
                    m = k >= s
                    st[:, s * pitch + k[m] - s] = src[:, m]
            else:
                st[:, k] = src
        moves = n // 4 if vec else n
        for tid in range(THREADS):
            d1, q = advance(0, 0, tid, moves)
            while d1 < wd:
                o = (wd - 1 - d1) * hw
                row = d1 * hw + i
                if vec:       # one 16-byte load from copy o & 3, one store
                    base = (o & 3) * pitch + (o >> 2) * 4 + 4 * q
                    out[:, row, 4 * q:4 * q + 4] = st[:, base:base + 4]
                    writes[row, 4 * q:4 * q + 4] += 1
                else:
                    out[:, row, q] = st[:, o + q]
                    writes[row, q] += 1
                d1, q = advance(d1, q, THREADS, moves)
    return out, writes


def _slices(nh, window, seed=0):
    wd, wh, ww = window
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nh, 2 * wd - 1, wh * ww, wh * ww)).astype(
        np.float32)


@pytest.mark.parametrize("nh", [1, 4, 32])
@pytest.mark.parametrize("window", [(8, 7, 7), (2, 3, 3), (3, 2, 5),
                                    (4, 7, 7)], ids=str)
def test_rowmap_matches_pallas_bit_for_bit(window, nh):
    """(8, 7, 7) and (4, 7, 7): N = 392, 196, the 16-byte path; (2, 3, 3)
    and (3, 2, 5): N = 18, 30, the scalar path."""
    v = _slices(nh, window)
    got, writes = emulate_expand(v, window[0])
    assert (writes == 1).all()
    want = np.asarray(_assemble(jnp.asarray(v), window[0], True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("window", [(2, 3, 3), (4, 7, 7)], ids=str)
def test_rowmap_without_staging_matches_pallas(window):
    """The path for rows that do not fit in shared memory, forced here by
    allowing none."""
    v = _slices(3, window, seed=1)
    got, writes = emulate_expand(v, window[0], max_smem=0)
    assert (writes == 1).all()
    want = np.asarray(_assemble(jnp.asarray(v), window[0], True))
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, expand_bias_reference(torch.from_numpy(v), window[0]).numpy())
