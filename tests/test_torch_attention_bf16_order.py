"""The order in which the bfloat16 packed attention backward sums its bias
gradient, against vitta_tpu's, on the CPU.

vitta_tpu's packed backward (pallas_attention.py:517-527) adds each
window's dl into dbias window by window; with the compact bias
(nh, 2wd-1, hw, hw) each window's dl is first collapsed over its frame
pairs, the blocks d1 - d2 = a - wd + 1 added in d1 order
(``_dbias_accum``, :384-400).  The port's bfloat16 backward kernel does
that collapse on chip: a strip holds every frame d1 of 16 // wd rows ii,
so each element (a, ii, jj) of a (window, head)'s compact partial takes
all of its terms in one strip, from one block, also where blocks share a
problem; a second launch adds the windows' partials in window order.
``compact_dbias_partials`` below is that plan in torch
(attention_kernels.cuh, Strips and the backward's collapse),
``dbias_in_window_order`` the plain version's order.

* Fed the same numpy dl, both give vitta_tpu's dbias bit for bit: each is
  the same float32 additions in the same order.  dl is the plain bfloat16
  backward's own, with and without the shift mask, at Swin-B's window
  (8, 7, 7) and two narrower ones, and the split case takes 2 and 3
  blocks a problem.
* The bfloat16 plain backward in that order stays within the tolerance its
  tests hold it to against vitta_tpu's packed backward in interpret mode
  (tests/test_torch_bf16_swin_kernels.py): dqkv within one bfloat16 ulp or
  2^-12 of the largest value, dbias within 1e-5 of its largest value,
  dense and compact.
* The bfloat16 Video Swin hands its attention the compact bias, so the
  model's backward takes the on-chip collapse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_attention import (_dbias_accum, _packed_attn_bwd,
                                            _packed_attn_fwd)
from vitta_tpu_torch.ops import cuda_attention as ca
from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference

torch.set_num_threads(1)

BF16 = torch.bfloat16
CHAINED = 2.0 ** -12
MAX_APART = 0.01
WINDOWS = [(8, 7, 7), (3, 5, 5), (2, 3, 3)]


def compact_strips(wd: int, hw: int):
    """The bfloat16 backward kernel's strips over the rows ii of a compact
    bias's window (attention_kernels.cuh, Strips): ``16 // wd`` rows ii a
    strip, each with its ``wd`` frames; returns [(ii0, rows), ...]."""
    if not 1 <= wd <= 16:
        raise ValueError(f"the bfloat16 kernels take a compact window of 1 "
                         f"to 16 frames, got {wd}")
    ips = 16 // wd
    return [(ii0, min(ips, hw - ii0)) for ii0 in range(0, hw, ips)]


def compact_dbias_partials(dl, wd: int, split: int = 1):
    """The (window, head) partials (B_, nh, 2wd-1, hw, hw) of the compact
    dbias as the bfloat16 backward kernel makes them from dl (B_, nh, N,
    N): block z of the ``split`` that share a problem takes strips z,
    z + split, ... (``compact_strips``), and for each (a, ii, jj) of its
    strip adds the frame pairs d1 - d2 = a - wd + 1 in d1 order.  Raises
    unless every element is written by exactly one strip, which is what
    keeps the order where blocks share a problem."""
    b_, nh, n, _ = dl.shape
    hw, a_dim = n // wd, 2 * wd - 1
    strips = compact_strips(wd, hw)
    part = torch.full((b_, nh, a_dim, hw, hw), float("nan"), dtype=dl.dtype)
    written = torch.zeros(a_dim, hw, dtype=torch.int64)
    for z in range(split):
        for ii0, rows in strips[z::split]:
            for a in range(a_dim):
                off = a - (wd - 1)
                acc = None
                for d1 in range(max(0, off), min(wd, wd + off)):
                    d2 = d1 - off
                    blk = dl[:, :, d1 * hw + ii0:d1 * hw + ii0 + rows,
                             d2 * hw:(d2 + 1) * hw]
                    acc = blk if acc is None else acc + blk
                part[:, :, a, ii0:ii0 + rows] = acc
                written[a, ii0:ii0 + rows] += 1
    if not bool((written == 1).all()):
        raise AssertionError("a compact partial written by no strip or by "
                             "two")
    return part


def _case(window, b_, nh, hd, nw, seed):
    """bfloat16 qkv and g, the compact bias (nh, 2wd-1, hw, hw) and the
    shift-like mask (nw, N, N) of 0 / -100 or None, from numpy."""
    wd, wh, ww = window
    n, hw = wd * wh * ww, wh * ww
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.normal(size=(b_, n, 3 * nh * hd)),
                       dtype=torch.float32).to(BF16)
    g = torch.tensor(rng.normal(size=(b_, n, nh * hd)),
                     dtype=torch.float32).to(BF16)
    vc = torch.tensor(rng.normal(size=(nh, 2 * wd - 1, hw, hw)) * 0.5,
                      dtype=torch.float32)
    mask = None
    if nw:
        m = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
        m[:, np.arange(n), np.arange(n)] = 0.0
        mask = torch.tensor(m, dtype=torch.float32)
    return qkv, g, vc, mask


def _plain_dl(qkv, g, vc, mask, nh, hd):
    """The plain bfloat16 backward's float32 dl (B_, nh, N, N)."""
    from vitta_tpu_torch.tools.bf16_checks import (
        packed_attention_bf16_intermediates)
    scale = hd ** -0.5
    _out, ms = ca.packed_attention_bf16_reference(qkv, vc, mask, scale, nh,
                                                  save_ms=True)
    _e, dl = packed_attention_bf16_intermediates(qkv, vc, mask, ms, g, scale,
                                                 nh)
    return dl


def _vitta_dbias(dl, wd, compact=True):
    """vitta_tpu's dbias from numpy dl: a zero numpy dbias into which
    ``_dbias_accum`` adds each window's dl per head, windows in grid
    order."""
    b_, nh, n, _ = dl.shape
    hw = n // wd
    shape = (nh, 2 * wd - 1, hw, hw) if compact else (nh, n, n)
    dbias = np.zeros(shape, np.float32)
    for b in range(b_):
        for h in range(nh):
            _dbias_accum(dbias, h, wd, dl[b, h])
    return dbias


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_kernel_dbias_order_is_vitta_tpus(window, masked, split):
    wd = window[0]
    nh, hd, nw = 2, 16, 2 if masked else 0
    b_ = 4 if masked else 2
    qkv, g, vc, mask = _case(window, b_, nh, hd, nw, seed=wd * 10 + split)
    dl = _plain_dl(qkv, g, vc, mask, nh, hd)
    want = _vitta_dbias(dl.numpy(), wd)
    part = compact_dbias_partials(dl, wd, split)
    assert part.shape == (b_, nh, 2 * wd - 1) + vc.shape[2:]
    got = torch.zeros_like(part[0])
    for window_part in part.unbind(0):
        got = got + window_part
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    # the plain version's order is the same
    plain = ca.dbias_in_window_order(dl, vc)
    assert np.array_equal(_bits(plain.numpy()), _bits(want))


@pytest.mark.parametrize("window", WINDOWS[1:], ids=str)
def test_dense_dbias_order_is_vitta_tpus(window):
    """With the dense bias each (window, head)'s partial is its dl, added
    window by window from zero."""
    wd = window[0]
    qkv, g, vc, mask = _case(window, 4, 2, 16, 2, seed=wd)
    dl = _plain_dl(qkv, g, vc, mask, 2, 16)
    want = _vitta_dbias(dl.numpy(), wd, compact=False)
    dense = expand_bias_reference(vc, wd)
    got = ca.dbias_in_window_order(dl, dense)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_strips_hold_every_frame_of_their_rows():
    """Swin-B's window: 25 strips of 2 rows ii (8 frames each), the last
    of one; a strip never holds a row twice, and the strips cover every
    row once."""
    strips = compact_strips(8, 49)
    assert len(strips) == 25 and strips[-1] == (48, 1)
    assert sum(rows for _ii0, rows in strips) == 49
    assert compact_strips(3, 25) == [(0, 5), (5, 5), (10, 5), (15, 5),
                                        (20, 5)]
    with pytest.raises(ValueError):
        compact_strips(17, 4)


def _ulp_within(name, got, want, floor):
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    tol = np.maximum(ulp, floor * np.abs(w).max())
    assert not (np.abs(g - w) > tol).any(), (name, np.abs(g - w).max())
    assert float((g != w).mean()) <= MAX_APART, name


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("window,nw", [((2, 3, 3), 2), ((3, 5, 5), 0)],
                         ids=str)
def test_bf16_backward_in_window_order_matches_pallas(window, nw, compact):
    wd = window[0]
    b_, nh, hd = 4, 2, 16
    qkv, g, vc, mask = _case(window, b_, nh, hd, nw, seed=7 + wd)
    bias = vc if compact else expand_bias_reference(vc, wd)
    scale = hd ** -0.5
    jq = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    jg = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    jbias = jnp.asarray(bias.numpy())
    _out, ms = _packed_attn_fwd(jq, jbias, jmask, scale, nh, save_ms=True,
                                interpret=True)
    dqkv, dbias = _packed_attn_bwd(jq, jbias, jmask, ms, jg, scale, nh,
                                   interpret=True)
    gq, gb = ca.packed_attention_bf16_backward_reference(
        qkv, bias, mask, torch.from_numpy(np.array(ms)), g, scale, nh)
    _ulp_within("dqkv", gq, dqkv, CHAINED)
    assert gb.dtype == torch.float32 and gb.shape == bias.shape
    err = float(np.abs(gb.numpy() - np.asarray(dbias)).max())
    assert err <= 1e-5 * float(np.abs(np.asarray(dbias)).max())


def test_bf16_swin_attention_takes_the_compact_bias(monkeypatch):
    """The bfloat16 Swin's attention receives the compact bias, so its
    backward collapses dl on chip; float32 keeps the dense bias."""
    from vitta_tpu_torch.models import swin
    seen = []
    real = swin.window_attention_packed

    def spy(qkv, bias, *args, **kw):
        seen.append((qkv.dtype, bias.dim()))
        return real(qkv, bias, *args, **kw)
    monkeypatch.setattr(swin, "window_attention_packed", spy)
    for dtype in ("bfloat16", "float32"):
        torch.manual_seed(0)
        model = swin.Recognizer3D(5, window_size=(2, 3, 3), embed_dim=128,
                                  depths=(2, 1), num_heads=(4, 8),
                                  dtype=dtype)
        x = torch.randn(2, 4, 48, 48, 3)
        model(x).float().sum().backward()
    assert (BF16, 4) in seen and (torch.float32, 3) in seen
    assert {d for t, d in seen if t == BF16} == {4}
