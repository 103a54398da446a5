"""The port's TANet against the JAX TANet and the plain-torch oracle
(tests/torch_tanet.py), through the same weights.

Logits and every tap (names, values and count leaves) agree with the JAX
model at tests/test_tanet_parity.py's tolerance, rtol 2e-3 / atol 2e-4:
two float32 conv stacks 50 layers deep, summing in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt.optim import tanet_trainable_mask as jax_trainable_mask
from vitta_tpu.models.layers import BatchNorm as JaxBatchNorm
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt.optim import tanet_trainable_mask
from vitta_tpu_torch.models.layers import BatchNorm
from vitta_tpu_torch.models.tanet import TANet
from vitta_tpu_torch.utils.checkpoint import (load_reference_checkpoint,
                                              tanet_state_dict_from_jax)

torch.set_num_threads(1)

T, NUM_CLASSES, HW = 4, 7, 32
RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    oracle = TorchTSN(NUM_CLASSES, T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    oracle.eval()
    variables = convert_tanet_checkpoint(oracle.state_dict(), NUM_CLASSES)
    port = TANet(NUM_CLASSES, clip_length=T)
    port.load_state_dict(oracle.state_dict(), strict=True)
    port.eval()
    return oracle, port, JaxTANet(num_classes=NUM_CLASSES, clip_length=T), \
        variables


def _clip(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, T, HW, HW, 3)).astype(np.float32)


def test_logits_and_taps_match_jax(models):
    _oracle, port, jmodel, variables = models
    x = _clip(0)
    want, aux = jmodel.apply(variables, jnp.asarray(x), train=False,
                             mutable=["taps"])
    taps = {}
    with torch.no_grad():
        got = port(torch.from_numpy(x), taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)

    jtaps = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            aux["taps"], is_leaf=lambda v: hasattr(v, "mean"))[0]:
        keys = [p.key for p in path if hasattr(p, "key")]
        jtaps.setdefault(".".join(keys[:-1]), {})[keys[-1]] = leaf
    assert set(taps) == set(jtaps)
    assert len(taps) == 1 + 16 * 5 + 4   # stem, 3 BN2d + 2 BN1d per block, 4 downsample
    for name, leaves in taps.items():
        assert set(leaves) == set(jtaps[name]), name
        for leaf, value in leaves.items():
            if leaf == "stat_n":
                assert value == float(jtaps[name][leaf]), name
                continue
            for g, w in zip(value, jtaps[name][leaf]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name}.{leaf}")


def test_logits_match_torch_oracle(models):
    oracle, port, _jmodel, _variables = models
    x = _clip(1)
    with torch.no_grad():
        want = oracle(torch.from_numpy(np.transpose(x, (0, 1, 4, 2, 3))))
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_state_dict_round_trip_through_jax(models):
    oracle, _port, _jmodel, variables = models
    sd = tanet_state_dict_from_jax(variables)
    assert set(sd) == set(oracle.state_dict())
    back = convert_tanet_checkpoint(sd, NUM_CLASSES)
    flat = lambda tree: {"/".join(p.key for p in path): np.asarray(v)
                         for path, v in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, got = flat(variables), flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    TANet(NUM_CLASSES, clip_length=T).load_state_dict(sd, strict=True)


def test_reference_checkpoint_loads_strict(models, tmp_path):
    oracle, _port, _jmodel, _variables = models
    path = tmp_path / "tanet.pth.tar"
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v for k, v in
                                           oracle.state_dict().items()}}, path)
    port = TANet(NUM_CLASSES, clip_length=T)
    port.load_state_dict(load_reference_checkpoint(str(path)), strict=True)
    for k, v in oracle.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k


def test_partial_bn_mask_matches_jax(models):
    _oracle, port, _jmodel, variables = models
    mask = tanet_trainable_mask(port.named_parameters())
    jmask = jax_trainable_mask(variables["params"])
    frozen = sorted(k for k, m in mask.items() if not m)
    jfrozen = sorted(
        "/".join(p.key for p in path) for path, m in
        jax.tree_util.tree_flatten_with_path(jmask)[0] if not m)
    assert len(frozen) == len(jfrozen) == 2 * (16 * 3 + 4)
    assert "base_model.bn1.weight" not in frozen
    assert all(".tam." not in k for k in frozen)


@pytest.mark.parametrize("shape", [(6, 5, 5, 16), (12, 8), (2, 3, 8)])
def test_batch_norm_batch_stat_form_matches_jax(shape):
    """BatchNorm in batch-stat form: output, gradients and the unbiased
    running update against the JAX BatchNorm."""
    c = shape[-1]
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, size=shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    scale, bias = rng.normal(size=c), rng.normal(size=c)
    mean, var = rng.normal(size=c), rng.uniform(0.5, 1.5, size=c)
    jbn = JaxBatchNorm(c)
    params = {"scale": jnp.asarray(scale, jnp.float32),
              "bias": jnp.asarray(bias, jnp.float32)}
    stats = {"mean": jnp.asarray(mean, jnp.float32),
             "var": jnp.asarray(var, jnp.float32)}

    def loss(p, xx):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx,
                           use_running_average=False,
                           update_running_stats=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), upd["batch_stats"]

    (gp, gx), new_stats = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    bn = BatchNorm(c, "bn")
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.tensor(v))
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt, None, use_running_average=False, update_running_stats=True)
    (y * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, gx), (bn.weight.grad, gp["scale"]),
                      (bn.bias.grad, gp["bias"]),
                      (bn.running_mean, new_stats["mean"]),
                      (bn.running_var, new_stats["var"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
