"""The TAM CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so that it runs on the card's machine, which has none:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances are
tests/test_pallas_tam.py's: forward 1e-5, gradients 2e-4; the kernel sums
dattn and dK in another order than the plain version's autograd.
"""

import numpy as np
import pytest
import torch

from vitta_tpu_torch.ops import cuda_tam
from vitta_tpu_torch.ops.cuda_tam import (tam_dynamic_conv,
                                          tam_dynamic_conv_reference)

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-5, 2e-4
SHAPES = [dict(), dict(t=3), dict(h=16), dict(n=1, t=16, h=7, w=7, c=64),
          dict(n=2, t=16, h=14, w=14, c=256), dict(c=30, w=5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the TAM kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(device, n=2, t=5, h=8, w=4, c=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, h, w, c)).astype(np.float32)
    attn = 1.0 / (1.0 + np.exp(-rng.normal(size=(n, t, c))))
    logits = rng.normal(size=(n, c, 3))
    kernel = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (x, attn, kernel, cot)]


def _value_and_grads(fn, x, attn, kernel, cot):
    ts = [v.clone().requires_grad_() for v in (x, attn, kernel)]
    out = fn(*ts)
    out.backward(cot)
    return [out.detach()] + [t.grad for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: str(s or "base"))
def test_kernel_matches_plain(cuda_device, shape):
    x, attn, kernel, cot = _inputs(cuda_device, **shape)
    cuda_tam.counters.reset()
    got = _value_and_grads(tam_dynamic_conv, x, attn, kernel, cot)
    assert (cuda_tam.counters.fwd, cuda_tam.counters.bwd) == (1, 1)
    want = _value_and_grads(tam_dynamic_conv_reference, x, attn, kernel, cot)
    for g, w, name, tol in zip(got, want, ("out", "dx", "dattn", "dkernel"),
                               (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)


@pytest.mark.cuda
def test_kernel_rejects_bfloat16_and_strided_input(cuda_device):
    x, attn, kernel, _ = _inputs(cuda_device)
    with pytest.raises(TypeError):
        tam_dynamic_conv(x.bfloat16(), attn, kernel)
    with pytest.raises(ValueError):
        tam_dynamic_conv(x.transpose(2, 3), attn, kernel)


@pytest.mark.cuda
def test_strided_gradient_is_copied_and_counted(cuda_device):
    x, attn, kernel, cot = _inputs(cuda_device, h=4)
    cuda_tam.counters.reset()
    xs = x.clone().requires_grad_()
    out = tam_dynamic_conv(xs, attn, kernel)
    # the same values in transposed memory: a non-contiguous cotangent
    strided = cot.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    out.backward(strided)
    assert cuda_tam.counters.grad_copies == 1
    ref = x.clone().requires_grad_()
    tam_dynamic_conv_reference(ref, attn, kernel).backward(cot)
    torch.testing.assert_close(xs.grad, ref.grad, rtol=GRAD_TOL, atol=GRAD_TOL)
