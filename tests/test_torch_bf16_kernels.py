"""The bfloat16 forms of the TAM and BatchNorm-statistics ops (PERF.md rows
1, 2 and 7) against vitta_tpu at bfloat16, on the CPU.

On the CPU each wrapper runs its plain versions, the kernels' twins, which
round where the kernels round (the kernels are held to them on the card:
tests/test_torch_cuda.py, chip_smoke.py).  Inputs come from a numpy seed;
x and the cotangents of activations are bfloat16, attn, the TAM's weights,
the norm's parameters and the statistics float32.

Tolerances, and why:
* against vitta_tpu (the algorithm): XLA rounds at its own points (a
  bfloat16 product or sum may be rounded where the port keeps float32), so
  the TAM's values and gradients are held at tests/test_pallas_tam.py's
  bfloat16 tolerance, rtol / atol 2e-2; y of the BatchNorm to one bfloat16
  ulp (the same float32 value rounded once, from two float32 formulas that
  may sit on either side of a rounding boundary); its statistics at rtol
  2e-3 / atol 1e-5 (float32 sums of those y, a few of them an ulp apart);
  its gradients at 2e-2 of each gradient's largest value (JAX rounds G, the
  summed cotangent of y, to bfloat16; the port keeps it float32).
* the rounding points themselves: each twin against float64 arithmetic on
  the same bfloat16 values: out, dx and y within one bfloat16 ulp (rounded
  once), the float32 outputs at rtol 1e-5 (float32 sums in another order).
* statistics of the rounded y: where every row of x is the same, the
  rounding of y does not average out, so the statistics of the rounded and
  of the unrounded y stand apart by more than ``ROUNDING_GAP`` (2^-12) of
  the mean in most channels (a bfloat16 rounding moves a value by up to
  2^-9 of it), while the port agrees with vitta_tpu to 1e-6 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.models.layers import BatchNorm as JaxBatchNorm
from vitta_tpu.ops.pallas_tam import (
    tam_dynamic_conv_reference as jax_tam_reference)
from vitta_tpu_torch.ops.cuda_stats import fused_bn_relu_stats
from vitta_tpu_torch.ops.cuda_tam import (
    tam_dynamic_conv, tam_dynamic_conv_backward_reference,
    tam_dynamic_conv_reference)

torch.set_num_threads(1)

BF16 = torch.bfloat16
JAX_TOL = 2e-2        # tests/test_pallas_tam.py's bfloat16 tolerance
F32_SUM_TOL = 1e-5
ROUNDING_GAP = 2.0 ** -12


def _bf16(a):
    """float32 numpy array -> bfloat16 tensor (the values both packages
    take)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _jnp(t):
    """A tensor as a JAX array of its dtype."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a):
    return np.asarray(a, np.float32)


def _ulp(v):
    """One bfloat16 ulp at each |v| (8 significant bits)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _within_one_ulp(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert (err <= _ulp(want) * (1 + 1e-6)).all(), (
        f"{what}: {int((err > _ulp(want)).sum())} values beyond one "
        f"bfloat16 ulp, worst {float(err.max()):.3e}")


def _scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (
        f"{what}: {err:.3e} beyond {tol} of {float(np.abs(want).max()):.3e}")


# ---------------------------------------------------------------------------
# the TAM, rows 1 and 2

def _tam_inputs(seed=0, n=2, t=5, h=4, w=6, c=16):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(n, t, h, w, c)))
    attn = torch.sigmoid(torch.from_numpy(
        rng.normal(size=(n, t, c)).astype(np.float32)))
    kernel = torch.softmax(torch.from_numpy(
        rng.normal(size=(n, c, 3)).astype(np.float32)), -1)
    cot = _bf16(rng.normal(size=(n, t, h, w, c)))
    return x, attn, kernel, cot


def test_tam_forward_matches_jax_at_bf16():
    x, attn, kernel, _ = _tam_inputs()
    got = tam_dynamic_conv(x, attn, kernel)
    want = jax_tam_reference(_jnp(x), _jnp(attn), _jnp(kernel))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=JAX_TOL,
                               atol=JAX_TOL)


def test_tam_vjp_matches_jax_at_bf16():
    x, attn, kernel, cot = _tam_inputs(1)
    leaves = [v.clone().requires_grad_() for v in (x, attn, kernel)]
    tam_dynamic_conv(*leaves).backward(cot)
    _, vjp = jax.vjp(jax_tam_reference, _jnp(x), _jnp(attn), _jnp(kernel))
    want = vjp(_jnp(cot))
    assert leaves[0].grad.dtype == BF16
    assert leaves[1].grad.dtype == leaves[2].grad.dtype == torch.float32
    for name, leaf, w in zip(("dx", "dattn", "dkernel"), leaves, want):
        _scaled(leaf.grad.float().numpy(), _np(w), JAX_TOL, name)


def _tam64(x, attn, kernel):
    """The TAM in float64 from the kernels' operands: x, and attn and the
    weights rounded to bfloat16."""
    t = x.shape[1]
    a = attn.to(BF16).double()[:, :, None, None, :]
    k = kernel.to(BF16).double()
    y = x.double() * a
    yp = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, 0, 1, 1))
    return sum(k[:, None, None, None, :, j] * yp[:, j:j + t]
               for j in range(3))


def test_tam_twins_round_where_the_kernels_round():
    """out and dx rounded once from the exact value; dattn and dkernel
    float32 sums; the gradients of attn and the weights are those of their
    rounded values."""
    x, attn, kernel, cot = _tam_inputs(2)
    out = tam_dynamic_conv_reference(x, attn, kernel)
    _within_one_ulp(out.float().numpy(), _tam64(x, attn, kernel).numpy(),
                    "out")
    dx, dattn, dkernel = tam_dynamic_conv_backward_reference(cot, x, attn,
                                                            kernel)
    assert dx.dtype == BF16 and dattn.dtype == dkernel.dtype == torch.float32
    x64 = x.double().requires_grad_()
    a64 = attn.to(BF16).double().requires_grad_()
    k64 = kernel.to(BF16).double().requires_grad_()
    t = x.shape[1]
    y = x64 * a64[:, :, None, None, :]
    yp = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, 0, 1, 1))
    out64 = sum(k64[:, None, None, None, :, j] * yp[:, j:j + t]
                for j in range(3))
    out64.backward(cot.double())
    _within_one_ulp(dx.float().numpy(), x64.grad.numpy(), "dx")
    np.testing.assert_allclose(dattn.numpy(), a64.grad.numpy(),
                               rtol=F32_SUM_TOL, atol=F32_SUM_TOL)
    np.testing.assert_allclose(dkernel.numpy(), k64.grad.numpy(),
                               rtol=F32_SUM_TOL, atol=F32_SUM_TOL)


# ---------------------------------------------------------------------------
# the BatchNorm statistics, row 7

def _bn_inputs(r=96, c=24, seed=0, same_rows=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, c)) * 2.0 + 0.5
    if same_rows:
        x = np.broadcast_to(x[:1], (r, c))
    return dict(
        x=_bf16(x),
        scale=torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
        bias=torch.from_numpy(rng.normal(size=c).astype(np.float32)),
        mean=torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32)),
        var=torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)),
        g_y=_bf16(rng.normal(size=(r, c))),
        g_m=torch.from_numpy(rng.normal(size=c).astype(np.float32)),
        g_v=torch.from_numpy(rng.normal(size=c).astype(np.float32)))


def _jax_bn(a):
    """vitta_tpu's BatchNorm in its inference form, tapped: y and its
    output-side statistics as a function of (x, scale, bias)."""
    c = a["x"].shape[-1]
    module = JaxBatchNorm(c)
    stats = {"mean": _jnp(a["mean"]), "var": _jnp(a["var"])}

    def fn(x, scale, bias):
        y, aux = module.apply(
            {"params": {"scale": scale, "bias": bias}, "batch_stats": stats},
            x, mutable=["taps"])
        stat = aux["taps"]["stat"]
        return y, stat.mean, stat.var
    return fn


def _port_bn(a, grad=False):
    leaves = [a[k].clone().requires_grad_(grad)
              for k in ("x", "scale", "bias")]
    y, (m, v) = fused_bn_relu_stats(*leaves, a["mean"], a["var"],
                                    relu=False)
    return leaves, y, m, v


def test_bn_stats_forward_matches_jax_at_bf16():
    a = _bn_inputs()
    _leaves, y, m, v = _port_bn(a)
    jy, jm, jv = _jax_bn(a)(*(_jnp(a[k]) for k in ("x", "scale", "bias")))
    assert y.dtype == BF16 and jy.dtype == jnp.bfloat16
    assert m.dtype == v.dtype == torch.float32
    _within_one_ulp(y.float().numpy(), _np(jy), "y")
    np.testing.assert_allclose(m.numpy(), _np(jm), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), _np(jv), rtol=2e-3, atol=1e-5)


def test_bn_statistics_are_those_of_the_rounded_output():
    a = _bn_inputs(r=64, c=64, seed=3, same_rows=True)
    _leaves, y, m, v = _port_bn(a)
    jy, jm, _jv = _jax_bn(a)(*(_jnp(a[k]) for k in ("x", "scale", "bias")))
    inv = torch.rsqrt(a["var"] + 1e-5) * a["scale"]
    unrounded = ((a["x"].float() - a["mean"]) * inv + a["bias"]).mean(0)
    gap = (unrounded - m).abs() / m.abs()
    # the rounding of one value per channel: above the gap in most channels
    assert float((gap > ROUNDING_GAP).float().mean()) > 0.5
    # ... while the port and vitta_tpu, both of the rounded y, agree far
    # closer (a channel whose y rounds apart would show a whole ulp)
    np.testing.assert_allclose(m.numpy(), _np(jm), rtol=1e-6, atol=0)
    assert torch.equal(m, y[0].float())


def test_bn_stats_vjp_matches_jax_at_bf16():
    a = _bn_inputs(seed=1)
    leaves, y, m, v = _port_bn(a, grad=True)
    torch.autograd.backward((y, m, v), (a["g_y"], a["g_m"], a["g_v"]))
    assert leaves[0].grad.dtype == BF16
    assert leaves[1].grad.dtype == leaves[2].grad.dtype == torch.float32
    _, vjp = jax.vjp(_jax_bn(a), *(_jnp(a[k]) for k in ("x", "scale",
                                                         "bias")))
    want = vjp(tuple(_jnp(a[k]) for k in ("g_y", "g_m", "g_v")))
    for name, leaf, w in zip(("dx", "dscale", "dbias"), leaves, want):
        _scaled(leaf.grad.float().numpy(), _np(w), JAX_TOL, name)


def test_bn_stats_twins_round_where_the_kernels_round():
    """y rounded once and the statistics those of that y; dx rounded once
    from the float32 G; dscale and dbias float32 sums.  Against float64
    with the rounding of y taken as the identity in the gradient."""
    a = _bn_inputs(seed=2)
    leaves, y, m, v = _port_bn(a, grad=True)
    torch.autograd.backward((y, m, v), (a["g_y"], a["g_m"], a["g_v"]))
    x64, s64, b64 = (a[k].double().requires_grad_()
                     for k in ("x", "scale", "bias"))
    inv = torch.rsqrt(a["var"].double() + 1e-5) * s64
    t = (x64 - a["mean"].double()) * inv + b64
    _within_one_ulp(y.detach().float().numpy(), t.detach().numpy(), "y")
    y64 = y.detach().double()
    np.testing.assert_allclose(m.detach().numpy(), y64.mean(0).numpy(),
                               rtol=F32_SUM_TOL, atol=F32_SUM_TOL)
    np.testing.assert_allclose(
        v.detach().numpy(), (y64.square().mean(0) - y64.mean(0) ** 2).numpy(),
        rtol=F32_SUM_TOL, atol=F32_SUM_TOL)
    # the rounded y in the statistics, the unrounded one's gradient
    ty = t + (y64 - t).detach()
    m64 = ty.mean(0)
    v64 = ty.square().mean(0) - m64 ** 2
    torch.autograd.backward((ty, m64, v64), (a["g_y"].double(),
                                             a["g_m"].double(),
                                             a["g_v"].double()))
    _within_one_ulp(leaves[0].grad.float().numpy(), x64.grad.numpy(), "dx")
    for name, leaf, w in (("dscale", leaves[1], s64), ("dbias", leaves[2],
                                                        b64)):
        np.testing.assert_allclose(leaf.grad.numpy(), w.grad.numpy(),
                                   rtol=F32_SUM_TOL, atol=F32_SUM_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(3, 5, 24), (2, 4, 4, 24)])
def test_bn_stats_any_rank_at_bf16(shape):
    """(..., C) of any rank: flattened to rows as a view, y in x's shape."""
    a = _bn_inputs(r=int(np.prod(shape[:-1])), c=shape[-1], seed=4)
    x = a["x"].reshape(shape)
    y, (m, v) = fused_bn_relu_stats(x, a["scale"], a["bias"], a["mean"],
                                    a["var"], relu=True)
    y2, (m2, v2) = fused_bn_relu_stats(a["x"], a["scale"], a["bias"],
                                       a["mean"], a["var"], relu=True)
    assert y.shape == shape and y.dtype == BF16
    assert torch.equal(y.reshape(y2.shape), y2)
    assert torch.equal(m, m2) and torch.equal(v, v2)
    assert float(y.float().min()) >= 0.0
