"""3-step trajectories of the port's engine against the JAX ``VittaEngine``
in the modes beside ``mean_var`` with SGD: BNS regularization (EMA and raw
batch statistics), Adam on the norm layers' affine parameters, and the
``tap_names`` override.  The tiny TANet, weights, videos, comparisons and
tolerances are tests/torch_engine_modes.py's (those of
tests/test_torch_engine.py); the cossim mode and the epoch-style loop are in
tests/test_torch_engine_cossim.py and tests/test_torch_engine_epoch.py, so
that the JAX compiles spread over test workers.

Adam: its first steps move every trained element by about lr whatever the
gradient's size (m / sqrt(v) is +-1), so an element whose gradient is
rounding noise moves by +-lr on either side at random.  The test therefore
holds each tensor's update to 10% of its norm, not 2%, at lr 1e-3, and
checks that every other parameter stays exactly where it was.
"""

import numpy as np
import pytest
import torch

from tests import torch_engine_modes as tm
from vitta_tpu.adapt.optim import norm_affine_mask as jax_norm_affine_mask
from vitta_tpu_torch.adapt.optim import norm_affine_mask
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

torch.set_num_threads(1)

T = 2


@pytest.fixture(scope="module")
def weights():
    sd, variables = tm.tanet_weights(T)
    return sd, variables, tm.mean_var_source(variables, T)


@pytest.mark.parametrize("running_manner", [True, False])
def test_bns_trajectory_matches_jax(weights, running_manner):
    sd, variables, _src = weights
    jeng, eng = tm.engines(sd, variables, None, T, stat_reg="BNS",
                           running_manner=running_manner)
    # layer3 and layer4: 29 BatchNorm2d and the 18 BatchNorm1d of their TAMs
    assert eng.tap_names == tuple(jeng.tap_names) and len(eng.tap_names) == 47
    assert eng.reg_specs[0].leaf == "stat_in"
    for name, s in eng.reg_specs[0].source.items():
        np.testing.assert_array_equal(s.mean.numpy(),
                                      np.asarray(jeng.source[name].mean))
        np.testing.assert_array_equal(s.var.numpy(),
                                      np.asarray(jeng.source[name].var))
    _state, _jstate, moved = tm.run_trajectories(jeng, eng, T, sd)
    assert moved >= 100


def test_bns_state_starts_from_zero_and_needs_no_source(weights):
    sd, variables, _src = weights
    _jeng, eng = tm.engines(sd, variables, None, T, stat_reg="BNS",
                            moving_avg=False)
    state = eng.init_state()
    # an EMA from zero even where mean_var would carry the cumulative meter
    assert all(not s.mean.any() and not s.var.any()
               for s in state.ema.values())
    views, clip, label = tm.videos(T, 1)[0]
    state, m = eng.adapt_eval_step(state, views, clip, label)
    assert np.isfinite(float(m.loss_reg)) and float(m.loss_reg) > 0
    # the source is a copy of the running statistics, not the buffers
    bn = eng.model.base_model.layer3[0].net.bn1
    src = eng.reg_specs[0].source[bn.tap_name]
    assert torch.equal(src.mean, bn.running_mean)
    assert src.mean.data_ptr() != bn.running_mean.data_ptr()


def test_adam_on_the_affine_parameters_matches_jax(weights):
    sd, variables, src = weights
    jeng, eng = tm.engines(sd, variables, src, T,
                           optim=dict(lr=1e-3, update_only_bn_affine=True))
    assert isinstance(eng.optimizer, torch.optim.Adam)
    mask = norm_affine_mask(eng.model.named_parameters())
    trained = {k for k, v in mask.items() if v}
    assert len(trained) == 170          # (53 BN2d + 32 BN1d) x (weight, bias)
    _state, _jstate, moved = tm.run_trajectories(jeng, eng, T, sd, rel=0.1,
                                                 only=trained)
    assert moved >= 0.9 * len(trained)


def test_norm_affine_mask_names_the_jax_package_s_leaves(weights):
    _sd, variables, _src = weights
    jmask = jax_norm_affine_mask(variables["params"])
    # the JAX mask as a state dict of 0 / 1 vectors, under the port's names
    as_sd = tanet_state_dict_from_jax({
        "params": _map_leaves(jmask, variables["params"]),
        "batch_stats": variables["batch_stats"]})
    from vitta_tpu_torch.models.tanet import TANet
    got = norm_affine_mask(TANet(tm.K, T).named_parameters())
    for name, trained in got.items():
        assert bool(as_sd[name].any()) == trained, name


def _map_leaves(mask, params):
    """``params`` with every leaf replaced by ones where ``mask`` is True
    and zeros elsewhere, so that the name mapping can carry the mask."""
    if isinstance(params, dict):
        return {k: _map_leaves(mask[k], v) for k, v in params.items()}
    return np.full(np.shape(params), float(mask), np.float32)


def test_tap_names_override_matches_jax(weights):
    sd, variables, src = weights
    names = ("base_model.layer2_1.bn2", "base_model.layer4_2.bn3",
             "base_model.not_a_layer")
    jeng, eng = tm.engines(sd, variables, src, T, tap_names=names)
    assert eng.tap_names == tuple(jeng.tap_names) == names[:2]
    tm.run_trajectories(jeng, eng, T, sd)
