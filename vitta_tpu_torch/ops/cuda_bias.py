"""Swin relative-position bias: compact form, dense expansion kernel.

The reference looks the (N, N) bias of a (wd, wh, ww) window up as
``table[relative_position_index]`` (swin_transformer.py:109-147).  The JAX
package factors that lookup (vitta_tpu/ops/pallas_bias.py): with
hw = wh*ww and A = 2wd-1,

    V[n, a, h1*ww+w1, h2*ww+w2] = table[a, h1-h2+wh-1, w1-w2+ww-1, n]

holds the bias's Toeplitz slices (``compact_bias``, plain PyTorch here as
it is plain XLA there), and the dense bias is the block arrangement

    B[n, d1*hw+i, d2*hw+j] = V[n, d1-d2+wd-1, i, j]

``expand_bias`` sends a CPU tensor to the plain block concatenation
(``expand_bias_reference``, pallas_bias.py:157-159) and a CUDA tensor to
the hand-written kernel in ``vitta_tpu_torch/csrc/bias.cu``, the
counterpart of pallas_bias.py:59.  Both move values and compute nothing, so
they agree bit for bit.  A backward pass on the card raises: its kernel
(pallas_bias.py:67) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from vitta_tpu_torch.ops._launch import (LaunchCounters, backward_not_ported,
                                         check_tensor, raise_on)

counters = LaunchCounters("fwd")


@functools.lru_cache(maxsize=8)
def _hw_index(wh: int, ww: int) -> np.ndarray:
    """(hw, hw) index of the combined (h, w)-axis displacement
    (h1-h2+wh-1)*(2ww-1) + (w1-w2+ww-1) (pallas_bias.py:47)."""
    h1, w1 = np.divmod(np.arange(wh * ww)[:, None], ww)
    h2, w2 = np.divmod(np.arange(wh * ww)[None, :], ww)
    return ((h1 - h2 + wh - 1) * (2 * ww - 1) + (w1 - w2 + ww - 1)).astype(
        np.int64)


def compact_bias(table, window_size: Tuple[int, int, int]):
    """Bias table -> Toeplitz slices V (nh, 2wd-1, hw, hw).

    ``table`` is the reference's flat ((2wd-1)(2wh-1)(2ww-1), nh) parameter
    or its 4-D view.  The JAX package selects with a one-hot matrix product
    (pallas_bias.py:120); an index gather selects the same values and is
    exact whatever the matmul precision."""
    wd, wh, ww = window_size
    nh = table.shape[-1]
    a_dim, hw = 2 * wd - 1, wh * ww
    idx = torch.from_numpy(_hw_index(wh, ww)).to(table.device).reshape(-1)
    t3 = table.to(torch.float32).reshape(a_dim, -1, nh)
    v = torch.index_select(t3, 1, idx).reshape(a_dim, hw, hw, nh)
    return v.permute(3, 0, 1, 2).contiguous()


def expand_bias_reference(v, wd: int):
    """(nh, 2wd-1, hw, hw) Toeplitz slices -> dense (nh, N, N), N = wd*hw."""
    rows = [torch.cat([v[:, d1 - d2 + wd - 1] for d2 in range(wd)], dim=2)
            for d1 in range(wd)]
    return torch.cat(rows, dim=1)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from vitta_tpu_torch.ops._build import load_library
        lib = load_library("bias")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vitta_bias_expand.argtypes = [p, p, i, i, i, p]
        lib.vitta_bias_expand.restype = i
        _LIB = lib
    return _LIB


def expand_bias_cuda(v, wd: int):
    """Expansion kernel: one launch, output allocated here."""
    if v.dim() != 4 or v.shape[1] != 2 * wd - 1 or v.shape[2] != v.shape[3]:
        raise ValueError(f"v must be (nh, {2 * wd - 1}, hw, hw), got shape "
                         f"{tuple(v.shape)}")
    nh, _, hw, _ = v.shape
    check_tensor("bias expansion", "v", v, v.shape, v.device)
    n = wd * hw
    out = torch.empty((nh, n, n), dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    with torch.cuda.device(v.device):
        code = _lib().vitta_bias_expand(v.data_ptr(), out.data_ptr(), nh, wd,
                                        hw, stream)
    raise_on(code, "bias expansion kernel")
    counters.fwd += 1
    return out


class ExpandBias(torch.autograd.Function):
    """The expansion kernel as an autograd node whose backward raises."""

    @staticmethod
    def forward(ctx, v, wd):
        return expand_bias_cuda(v, wd)

    @staticmethod
    def backward(ctx, g):
        backward_not_ported("bias expansion", 6)


def expand_bias(v, wd: int):
    """Toeplitz slices (nh, 2wd-1, hw, hw) -> dense bias (nh, N, N).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel,
    which raises on any dtype other than float32 or a non-contiguous
    input."""
    if v.device.type == "cpu":
        return expand_bias_reference(v, wd)
    if v.device.type != "cuda":
        raise ValueError(f"no bias expansion for device {v.device}")
    return ExpandBias.apply(v, wd)
