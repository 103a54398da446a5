"""``VITTA_BF16_MOMENTUM`` in the port: ``HalfMomentumSGD`` (bfloat16
momentum buffers over float32 masters) against vitta_tpu's
``fused_sgd_step`` on a bfloat16 momentum tree, from the same parameters
and gradients, over K = 5 steps.

As tests/test_optim_half_momentum.py bounds vitta_tpu's: step 0 exact (the
buffers start at 0 and the arithmetic is float32, so the parameters and
the bfloat16 buffers are vitta_tpu's bits, and within that file's 1e-7 of
torch's float32 SGD); over 5 steps each parameter
within 1e-5 of its largest magnitude of vitta_tpu's bfloat16 trajectory
and of the port's own float32 SGD.  The flag is read as vitta_tpu reads it,
and the engine's optimizer follows it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitta_tpu.adapt.optim import fused_sgd_step
from vitta_tpu.adapt.optim import half_momentum_enabled as jax_enabled
from vitta_tpu.config import OptimConfig as JaxOptimConfig
from vitta_tpu_torch.adapt.optim import (HalfMomentumSGD, build_optimizer,
                                         half_momentum_enabled)
from vitta_tpu_torch.config import OptimConfig

K = 5


def _trees():
    rng = np.random.default_rng(0)
    params = {f"w{i}": (rng.normal(size=(16, 32)) * 0.1).astype(np.float32)
              for i in range(3)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(K)]
    return params, grads


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_trajectory_matches_fused_sgd_step():
    cfg, jcfg = OptimConfig(), JaxOptimConfig()
    params, grads = _trees()
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    t32 = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in params.items()}
    opt = HalfMomentumSGD(tp.values(), lr=cfg.lr, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    sgd = torch.optim.SGD(t32.values(), lr=cfg.lr, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jv = {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in params.items()}
    for s in range(K):
        for k in params:
            tp[k].grad = torch.from_numpy(grads[s][k])
            t32[k].grad = torch.from_numpy(grads[s][k])
        opt.step()
        sgd.step()
        jp, jv = fused_sgd_step(jcfg, jp, jv,
                                {k: jnp.asarray(g) for k, g in grads[s].items()})
        if s == 0:
            for k in params:
                np.testing.assert_array_equal(tp[k].detach().numpy(),
                                              np.asarray(jp[k]))
                # torch's SGD adds -lr * v in one fused step, which rounds
                # once where p - (lr * v) rounds twice: one float32 ulp on a
                # few elements, the atol of tests/test_optim_half_momentum.py
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           t32[k].detach().numpy(), rtol=0,
                                           atol=1e-7)
                v = opt.state[tp[k]]["momentum_buffer"]
                np.testing.assert_array_equal(
                    _bits(v), np.asarray(jv[k]).view(np.int16))
    for k in params:
        v = opt.state[tp[k]]["momentum_buffer"]
        assert v.dtype == torch.bfloat16 and tp[k].dtype == torch.float32
        got = tp[k].detach().numpy()
        for want in (np.asarray(jp[k]), t32[k].detach().numpy()):
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            assert rel < 1e-5, (k, rel)


def test_flag_and_engine_optimizer(monkeypatch):
    model = torch.nn.Linear(4, 3)
    for value, on in (("", False), ("1", True), ("0", True)):
        monkeypatch.setenv("VITTA_BF16_MOMENTUM", value)
        assert half_momentum_enabled() == jax_enabled() == on
        opt = build_optimizer(OptimConfig(), model, arch="swin")
        assert isinstance(opt, HalfMomentumSGD) == on
        assert isinstance(opt, torch.optim.SGD) != on
    monkeypatch.delenv("VITTA_BF16_MOMENTUM")
    assert not half_momentum_enabled()
    # Adam on the norm affine parameters is not touched by the flag
    monkeypatch.setenv("VITTA_BF16_MOMENTUM", "1")
    cfg = OptimConfig(update_only_bn_affine=True)
    norm = torch.nn.Sequential(torch.nn.Linear(4, 4))
    norm.add_module("norm", torch.nn.LayerNorm(4))
    assert isinstance(build_optimizer(cfg, norm), torch.optim.Adam)


def test_no_closure():
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(ValueError, match="closure"):
        HalfMomentumSGD([p], lr=0.1, momentum=0.9, weight_decay=0.0).step(
            lambda: 0.0)
