"""The port's TAM dynamic temporal conv and TAM module against the JAX
package, and the CUDA kernel against its plain version.

* The plain PyTorch version against the Pallas kernel in interpret mode,
  forward and all three gradients, at the shapes and tolerances of
  tests/test_pallas_tam.py (forward 1e-5, gradients 2e-4).
* The port's ``TAM`` module against the JAX ``TAM`` with the same weights.

The CUDA kernel against the plain version is in tests/test_torch_cuda.py,
which imports no JAX so that it can run on the card's machine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.models.tam import TAM as JaxTAM
from vitta_tpu.ops.pallas_tam import tam_dynamic_conv as jax_tam_dynamic_conv
from vitta_tpu_torch.models.tam import TAM
from vitta_tpu_torch.ops import cuda_tam
from vitta_tpu_torch.ops.cuda_tam import (tam_dynamic_conv,
                                          tam_dynamic_conv_reference)
from vitta_tpu_torch.utils.checkpoint import tam_state_dict_from_jax

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-5, 2e-4


def _inputs(n=2, t=5, h=8, w=4, c=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, h, w, c)).astype(np.float32)
    attn = 1.0 / (1.0 + np.exp(-rng.normal(size=(n, t, c))))
    logits = rng.normal(size=(n, c, 3))
    kernel = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return x, attn.astype(np.float32), kernel.astype(np.float32), cot


def _torch_value_and_grads(fn, x, attn, kernel, cot, device="cpu"):
    ts = [torch.tensor(a, device=device, requires_grad=True)
          for a in (x, attn, kernel)]
    out = fn(*ts)
    out.backward(torch.tensor(cot, device=device))
    return [out.detach().cpu().numpy()] + [t.grad.cpu().numpy() for t in ts]


SHAPES = [dict(), dict(t=3), dict(h=16), dict(n=1, t=16, h=7, w=7, c=64)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: str(s or "base"))
def test_plain_matches_pallas_interpret(shape):
    x, attn, kernel, cot = _inputs(**shape)
    fwd = lambda *a: jax_tam_dynamic_conv(*a, interpret=True)
    out, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(attn),
                       jnp.asarray(kernel))
    want = [out, *vjp(jnp.asarray(cot))]
    got = _torch_value_and_grads(tam_dynamic_conv_reference, x, attn, kernel,
                                 cot)
    for g, w, name, tol in zip(got, want, ("out", "dx", "dattn", "dkernel"),
                               (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=name)


def test_cpu_tensors_take_the_plain_version():
    x, attn, kernel, _ = _inputs()
    cuda_tam.counters.reset()
    got = tam_dynamic_conv(*map(torch.from_numpy, (x, attn, kernel)))
    want = tam_dynamic_conv_reference(*map(torch.from_numpy, (x, attn, kernel)))
    assert torch.equal(got, want)
    assert (cuda_tam.counters.fwd, cuda_tam.counters.bwd) == (0, 0)


def test_other_devices_raise():
    x = torch.zeros(1, 3, 2, 2, 4, device="meta")
    with pytest.raises(ValueError):
        tam_dynamic_conv(x, torch.zeros(1, 3, 4, device="meta"),
                         torch.zeros(1, 4, 3, device="meta"))


def _jax_tam(c, t, nt_hw, seed=0):
    """A JAX TAM with random weights and BN running statistics."""
    model = JaxTAM(in_channels=c)
    x0 = jnp.zeros((nt_hw[0], nt_hw[1], nt_hw[2], c), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0, t)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("c,t,h", [(32, 4, 6), (64, 3, 5)])
def test_tam_module_matches_jax(c, t, h):
    n = 2
    model, variables = _jax_tam(c, t, (n * t, h, h))
    x = np.random.default_rng(1).normal(size=(n * t, h, h, c)).astype(np.float32)
    want, aux = model.apply(variables, jnp.asarray(x), t, mutable=["taps"])

    tam = TAM(c, t, "tam")
    tam.load_state_dict(tam_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    taps = {}
    with torch.no_grad():
        got = tam(torch.from_numpy(x), taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert set(taps) == {"tam.g_bn", "tam.l_bn"}
    for bn in ("g_bn", "l_bn"):
        jtaps = aux["taps"][bn]
        assert set(taps[f"tam.{bn}"]) == set(jtaps)
        for leaf, value in taps[f"tam.{bn}"].items():
            if leaf == "stat_n":
                assert value == float(jtaps[leaf])
                continue
            for g, w in zip(value, jtaps[leaf]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{bn}.{leaf}")


def test_tam_module_batch_stat_grads_match_jax():
    """fix_BNS off: batch-stat BN1d inside the TAM, gradients and the
    running-statistic update against the JAX TAM."""
    c, t, h, n = 32, 4, 5, 2
    model, variables = _jax_tam(c, t, (n * t, h, h))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n * t, h, h, c)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def loss(params, xx):
        y, upd = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             xx, t, use_running_average=False,
                             update_running_stats=True,
                             mutable=["batch_stats"])
        return jnp.sum(y * cot), upd["batch_stats"]

    (gp, gx), new_stats = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    want = tam_state_dict_from_jax(gp, new_stats)

    tam = TAM(c, t, "tam")
    tam.load_state_dict(tam_state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    y = tam(xt, None, use_running_average=False, update_running_stats=True)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for k, p in tam.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for k, b in tam.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
