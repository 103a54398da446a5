"""The BatchNorm + ReLU + channel-statistics op of the port
(vitta_tpu_torch/ops/cuda_stats.py) against the JAX package's Pallas kernel
in interpret mode, on the CPU, and its wiring into ``BatchNorm``.

On the CPU the wrapper runs its plain version (the CUDA kernels are held
against that version on the card, tests/test_torch_cuda.py).  Inputs come
from a numpy seed.  Tolerances are tests/test_pallas_stats.py's: y rtol /
atol 1e-5, mean rtol 1e-5 / atol 1e-6, variance rtol 1e-4 / atol 1e-5 (the
one-pass ``E[y^2] - m^2`` from sums taken in another order).  Gradients are
compared with ``jax.grad`` of the same formula in ``jnp`` at rtol 1e-4 /
atol 1e-5 (sums over R rows in another order); the backward kernel's plain
version (the formula the kernel evaluates) with torch's autograd of the
forward at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.ops.pallas_stats import fused_bn_relu_stats as jax_fused
from vitta_tpu_torch.models.layers import (BatchNorm, LayerNorm, Taps,
                                           flatten_taps)
from vitta_tpu_torch.ops import cuda_stats
from vitta_tpu_torch.ops.cuda_stats import (
    fused_bn_relu_stats, fused_bn_relu_stats_backward_reference,
    fused_bn_relu_stats_reference)
from vitta_tpu_torch.ops.stats import channel_stats

torch.set_num_threads(1)

# the two cases of tests/test_pallas_stats.py, and BN1d's C = 32 with R no
# multiple of 8 (one row tile of the whole array in the Pallas kernel)
CASES = [(512, 128, True), (96, 256, False), (100, 32, True),
         (100, 32, False)]


def _inputs(r, c, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(r, c)).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
        bias=rng.normal(size=c).astype(np.float32),
        mean=(rng.normal(size=c) * 0.1).astype(np.float32),
        var=rng.uniform(0.5, 2.0, c).astype(np.float32),
        g_y=rng.normal(size=(r, c)).astype(np.float32),
        g_m=rng.normal(size=c).astype(np.float32),
        g_v=rng.normal(size=c).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("r,c,relu", CASES)
def test_forward_matches_the_pallas_kernel(r, c, relu):
    a = _inputs(r, c)
    args = [a[k] for k in ("x", "scale", "bias", "mean", "var")]
    jy, jstats = jax_fused(*(jnp.asarray(v) for v in args), relu=relu,
                           interpret=True)
    cuda_stats.counters.reset()
    y, stats = fused_bn_relu_stats(*(_t(v) for v in args), relu=relu)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (cuda_stats.counters.fwd, cuda_stats.counters.bwd) == (0, 0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats.mean.numpy(), np.asarray(jstats.mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats.var.numpy(), np.asarray(jstats.var),
                               rtol=1e-4, atol=1e-5)


def _jnp_loss(x, scale, bias, mean, var, g_y, g_m, g_v, relu, eps=1e-5):
    inv = jax.lax.rsqrt(var + eps) * scale
    y = (x - mean) * inv + bias
    if relu:
        y = jnp.maximum(y, 0.0)
    m = jnp.mean(y, axis=0)
    v = jnp.mean(y * y, axis=0) - m * m
    return jnp.sum(y * g_y) + jnp.sum(m * g_m) + jnp.sum(v * g_v)


@pytest.mark.parametrize("r,c,relu", CASES)
def test_gradients_match_jax(r, c, relu):
    """Cotangents on all three outputs: torch's autograd of the plain
    version, and the backward kernel's plain version, against ``jax.grad``
    of the same formula."""
    a = _inputs(r, c, seed=1)
    want = jax.grad(_jnp_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a[k]) for k in ("x", "scale", "bias", "mean", "var",
                                      "g_y", "g_m", "g_v")), relu)
    x, scale, bias = (_t(a[k]).requires_grad_()
                      for k in ("x", "scale", "bias"))
    mean, var = _t(a["mean"]), _t(a["var"])
    cots = [_t(a[k]) for k in ("g_y", "g_m", "g_v")]
    y, (m, v) = fused_bn_relu_stats(x, scale, bias, mean, var, relu=relu)
    torch.autograd.backward((y, m, v), cots)
    written_out = fused_bn_relu_stats_backward_reference(
        x.detach(), scale.detach(), bias.detach(), mean, var, m.detach(),
        *cots, relu=relu)
    for got, formula, w, name in zip((x.grad, scale.grad, bias.grad),
                                     written_out, want,
                                     ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(formula.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{name} written out")


@pytest.mark.parametrize("which", ["y", "m", "v"])
def test_backward_formula_with_one_cotangent(which):
    """Each cotangent may be absent: the written-out backward with the
    others None against autograd with the others unused."""
    a = _inputs(60, 24, seed=2)
    x, scale, bias = (_t(a[k]).requires_grad_()
                      for k in ("x", "scale", "bias"))
    mean, var = _t(a["mean"]), _t(a["var"])
    y, (m, v) = fused_bn_relu_stats(x, scale, bias, mean, var, relu=True)
    out, cot = {"y": (y, _t(a["g_y"])), "m": (m, _t(a["g_m"])),
                "v": (v, _t(a["g_v"]))}[which]
    out.backward(cot)
    kw = {f"g_{which}": cot}
    got = fused_bn_relu_stats_backward_reference(
        x.detach(), scale.detach(), bias.detach(), mean, var, m.detach(),
        relu=True, **kw)
    for g, w, name in zip(got, (x.grad, scale.grad, bias.grad),
                          ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_leading_axes_are_flattened_and_restored():
    a = _inputs(4 * 6 * 6, 16, seed=3)
    x = _t(a["x"]).reshape(4, 6, 6, 16)
    args = [_t(a[k]) for k in ("scale", "bias", "mean", "var")]
    y, stats = fused_bn_relu_stats(x, *args, relu=False)
    y2, stats2 = fused_bn_relu_stats(x.reshape(-1, 16), *args, relu=False)
    assert y.shape == x.shape and stats.mean.shape == (16,)
    assert torch.equal(y.reshape(-1, 16), y2)
    np.testing.assert_allclose(stats.var.numpy(), stats2.var.numpy(),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the wiring into BatchNorm, and Taps(names=...)

def _bn(c, name="blk.bn", stat_types=("spatiotemp",), clip_len=0, seed=0):
    bn = BatchNorm(c, name, stat_types, clip_len)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn


def _before_the_wiring(bn, x):
    """``BatchNorm.forward``'s inference form and output tap as they were
    before the op was wired in: addcmul, then ``channel_stats``."""
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = torch.addcmul(bn.bias - bn.running_mean * inv, x, inv)
    return y, channel_stats(y)


@pytest.mark.parametrize("shape", [(8, 5, 5, 12), (6, 4, 12), (10, 12)],
                         ids=str)
def test_batch_norm_output_and_taps_unchanged(shape):
    bn = _bn(shape[-1])
    x = torch.from_numpy(np.random.default_rng(4).normal(size=shape)
                         .astype(np.float32))
    want_y, want = _before_the_wiring(bn, x)
    for taps in ({}, Taps({"stat"}), Taps({"stat", "stat_n"}, {"blk.bn"})):
        y = bn(x, taps)
        assert torch.equal(y, want_y)
        stat = flatten_taps(taps)["blk.bn"]
        assert torch.equal(stat.mean, want.mean)
        assert torch.equal(stat.var, want.var)
    assert torch.equal(bn(x), want_y)                 # untapped
    assert torch.equal(bn(x, Taps({"stat_in"})), want_y)   # output not read


def test_batch_norm_other_stat_types_are_reduced_from_y():
    bn = _bn(6, stat_types=("spatiotemp", "temp", "cossim"), clip_len=2)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 3, 3, 6))
                         .astype(np.float32))
    taps = {}
    y = bn(x, taps)
    slot = taps["blk.bn"]
    assert set(slot) == {"stat", "stat_temp", "stat_cossim", "stat_in",
                         "stat_in_temp", "stat_in_cossim", "stat_n"}
    y5 = y.reshape(4, 2, 3, 3, 6)
    want = channel_stats(y5, stat_type="temp", time_axis=1)
    assert torch.equal(slot["stat_temp"].mean, want.mean)
    assert slot["stat_temp"].mean.shape == (6, 3, 3)
    assert slot["stat_cossim"].mean.shape == (1,)     # T = 2: one pair
    assert not slot["stat_cossim"].var.any()
    assert slot["stat_n"] == 4.0


def test_batch_stat_form_stays_plain():
    """With batch statistics the mean and var carry gradients: the op is
    not used, and the gradient reaches x through them."""
    bn = _bn(5)
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    taps = Taps({"stat"})
    y = bn(x, taps, use_running_average=False)
    np.testing.assert_allclose(y.mean(0).detach().numpy(),
                               bn.bias.detach().numpy(), atol=1e-5)
    y.square().sum().backward()
    assert x.grad is not None and "blk.bn" in taps


def test_taps_names_reduce_only_at_the_named_layers():
    a, b = _bn(4, "net.a"), _bn(4, "net.b", seed=1)
    ln = LayerNorm(4, "net.ln")
    x = torch.randn(3, 2, 4, generator=torch.Generator().manual_seed(0))
    taps = Taps({"stat", "stat_n"}, names={"net.b", "net.ln"})
    ln(b(a(x, taps), taps), taps)
    assert set(taps) == {"net.b", "net.ln"}
    assert set(taps["net.b"]) == {"stat", "stat_n"}
    every = Taps({"stat"})
    ln(b(a(x, every), every), every)
    assert set(every) == {"net.a", "net.b", "net.ln"}
    assert every.names is None
    plain = {}
    a(x, plain)
    assert set(plain["net.a"]) == {"stat", "stat_in", "stat_n"}


def test_engine_taps_only_the_layers_it_reads():
    """The engine's tap dict names its specs' layers: a tapped forward of
    the tiny TANet reduces at those and nowhere else."""
    from vitta_tpu_torch.models.tanet import TANet
    torch.manual_seed(0)
    model = TANet(3, clip_length=2, dropout=0.0)
    x = torch.randn(1, 2, 32, 32, 3)
    every = Taps({"stat"})
    with torch.no_grad():
        want = model(x, every)
        names = {n for n in every if "layer4" in n and "tam" not in n}
        assert len(names) == 10 and len(every) == 85
        some = Taps({"stat"}, names)
        got = model(x, some)
    assert torch.equal(got, want) and set(some) == names
    for n in names:
        assert torch.equal(some[n]["stat"].mean, every[n]["stat"].mean)
