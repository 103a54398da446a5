"""What the projection-fused window attention's forward keeps for its
backward, and how the backward's bias gradients are summed, on the CPU.

The forward of vitta_tpu_torch/ops/cuda_attention_proj.py keeps qkv (and,
with the LayerNorm, y) beside o_att and ms, so that its backward makes no
qkv product and no LayerNorm forward; vitta_tpu's Pallas backward
recomputes both.  Held here:

* the kept qkv is the qkv projection of x (of y in the LayerNorm form),
  bit for bit, and o_att and ms are the packed attention's at it: the plain
  backward fed them (tests/test_torch_swin_proj.py holds it to the Pallas
  backward in interpret mode and to autograd, every case, with and without
  the mask and gy) computes from the same tensors as the JAX package's;
* the bias gradients dbproj and dbqkv, taken by the card's weight-gradient
  products as the column sums of their A, chunk by chunk and slice by slice,
  one more row of each chunk's partials added in chunk order
  (``tests/torch_tf32.py:col_sums``), stay within ``PROJ_GRAD_REL`` of
  float64 at every Swin-B stage's row count of 2 clips: 5e-5 of the largest
  value, the card's tolerance for every gradient of the op
  (tests/test_torch_cuda.py, chip_smoke.py's PROJ_BWD_TOL).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_swin_proj import CASES, EPS, _inputs, _t, _torch_args
from tests.torch_tf32 import col_sums
from vitta_tpu_torch.ops.cuda_attention import packed_attention_reference
from vitta_tpu_torch.ops.cuda_attention_proj import (
    ln_proj_attention_reference, proj_attention_reference)
from vitta_tpu_torch.ops.cuda_ln import layer_norm_reference

torch.set_num_threads(1)

PROJ_GRAD_REL = 5e-5


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_kept_residuals_are_those_the_backward_recomputed(case, with_mask):
    d = _inputs(case, with_mask, seed=9)
    x, w, bias, mask = _torch_args(d)
    _out, qkv, o_att, ms = proj_attention_reference(
        x, *w, bias, mask, d["scale"], d["nh"], save_residuals=True)
    assert torch.equal(qkv, F.linear(x, w[0], w[1]))
    want_o, want_ms = packed_attention_reference(qkv, bias, mask, d["scale"],
                                                 d["nh"], True)
    assert torch.equal(o_att, want_o) and torch.equal(ms, want_ms)
    gm, bt = _t(d["gamma"]), _t(d["beta"])
    _out, y, qkv, o_att, ms = ln_proj_attention_reference(
        x, gm, bt, EPS, *w, bias, mask, d["scale"], d["nh"],
        save_residuals=True)
    assert torch.equal(y, layer_norm_reference(x, gm, bt, EPS))
    assert torch.equal(qkv, F.linear(y, w[0], w[1]))
    want_o, want_ms = packed_attention_reference(qkv, bias, mask, d["scale"],
                                                 d["nh"], True)
    assert torch.equal(o_att, want_o) and torch.equal(ms, want_ms)


# Swin-B's widths and rows of 2 clips per stage; a bias gradient of C
# (dbproj, beside dwproj (C, C)) and of 3C (dbqkv, beside dwqkv (3C, C))
STAGE_ROWS = {128: 50176, 256: 12544, 512: 3136, 1024: 784}


@pytest.mark.parametrize("bias", ["dbproj", "dbqkv"])
@pytest.mark.parametrize("c", list(STAGE_ROWS))
def test_bias_gradient_from_the_chunk_partials(c, bias):
    """A cotangent of the spread chip_smoke.py draws, with a mean offset
    per column as a real one has; float64 column sums as the reference."""
    rows, width = STAGE_ROWS[c], c if bias == "dbproj" else 3 * c
    rng = np.random.default_rng(c + width)
    a = (rng.normal(size=(rows, width))
         + rng.normal(size=width) * 0.05).astype(np.float32)
    want = a.astype(np.float64).sum(0)
    got = col_sums(torch.from_numpy(a), c).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= PROJ_GRAD_REL, err
