"""The port's Video Swin against the JAX package's, on the CPU: the tiny
config of tests/test_swin_parity.py (shifted windows, clamped windows,
PatchMerging padding), weights shared through ``swin_state_dict_from_jax``
and back through ``convert_swin_checkpoint``.

Tolerances: logits rtol 2e-3 / atol 2e-4, test_swin_parity.py's bound
between the JAX model and the plain torch oracle (float32 matrix products
summed in different orders through six blocks); tap means and variances
rtol 1e-3 / atol 1e-5, the bound of that file's hook test; eval
predictions and top-1/top-5 exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import swin_ucf101_preset as jax_preset
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.models.swin import compute_shift_mask as jax_shift_mask
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu.utils.checkpoint import swin_norm_layers as jax_swin_norm_layers
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models.layers import flatten_taps
from vitta_tpu_torch.models.swin import (Recognizer3D, compute_shift_mask,
                                         drop_path, get_window_size)
from vitta_tpu_torch.utils.checkpoint import (swin_norm_layers,
                                              swin_state_dict_from_jax)

torch.set_num_threads(1)

K = 6
DEPTHS = (1, 1, 2, 1)
EMBED = 8
HEADS = (1, 2, 4, 8)
WINDOW = (2, 3, 3)
PATCH = (2, 4, 4)
T, HW = 4, 24
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)


def _cfg(preset):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0, **MODEL_KW))


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(K, PATCH, EMBED, DEPTHS, HEADS, WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    oracle.eval()
    variables = convert_swin_checkpoint(oracle.state_dict(), K, depths=DEPTHS,
                                        window_size=WINDOW)
    jm = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW)
    pm = Recognizer3D(drop_path_rate=0.0, **MODEL_KW)
    pm.load_state_dict(oracle.state_dict(), strict=True)
    return oracle, jm, variables, pm


def _clip(seed, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, T, HW, HW, 3)).astype(np.float32)


def test_reference_state_dict_loads_strict(models):
    oracle, _jm, _variables, pm = models
    assert set(pm.state_dict()) == set(oracle.state_dict())
    for k, v in oracle.state_dict().items():
        assert pm.state_dict()[k].shape == v.shape, k
        assert pm.state_dict()[k].dtype == v.dtype, k


def test_state_dict_round_trips_through_jax(models):
    oracle, _jm, variables, _pm = models
    sd = swin_state_dict_from_jax(variables, depths=DEPTHS,
                                  window_size=WINDOW)
    want = oracle.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    back = convert_swin_checkpoint(sd, K, depths=DEPTHS, window_size=WINDOW)
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


def test_logits_match_jax_and_oracle(models):
    oracle, jm, variables, pm = models
    x = _clip(0)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
        ref = oracle(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3)))).numpy()
    assert got.shape == (2, K)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)


def test_weights_from_jax_give_the_same_logits(models):
    _oracle, jm, variables, _pm = models
    fresh = Recognizer3D(drop_path_rate=0.0, **MODEL_KW)
    fresh.load_state_dict(
        swin_state_dict_from_jax(variables, depths=DEPTHS,
                                 window_size=WINDOW), strict=True)
    x = _clip(4)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = fresh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("leaf", ["stat", "stat_in"])
def test_taps_match_jax(models, leaf):
    _oracle, jm, variables, pm = models
    x = _clip(1)
    _, aux = jm.apply(variables, jnp.asarray(x), train=False,
                      mutable=["taps"])
    want = jax_flatten_taps(aux["taps"], leaf)
    taps = {}
    with torch.no_grad():
        pm(torch.from_numpy(x), taps)
    got = flatten_taps(taps, leaf)
    assert set(got) == set(want)
    assert set(got) == {n for n, _ in swin_norm_layers(DEPTHS)}
    assert not any("patch_embed" in n for n in got)
    for name, s in got.items():
        np.testing.assert_allclose(s.mean.numpy(), np.asarray(want[name].mean),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(s.var.numpy(), np.asarray(want[name].var),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_tap_count_leaf_is_the_batch(models):
    _oracle, _jm, _variables, pm = models
    taps = {}
    with torch.no_grad():
        pm(torch.from_numpy(_clip(2, n=3)), taps)
    assert all(v["stat_n"] == 3.0 for v in taps.values())


def test_norm_layer_lists_agree():
    for depths in (DEPTHS, (2, 2, 18, 2)):
        assert swin_norm_layers(depths) == jax_swin_norm_layers(depths)
    assert len(swin_norm_layers()) == 52   # 24 x 2 + 3 + 1


@pytest.mark.parametrize("dims,window,shift", [
    ((2, 6, 6), (2, 3, 3), (1, 1, 1)), ((8, 56, 56), (8, 7, 7), (4, 3, 3)),
    ((2, 3, 3), (2, 3, 3), (0, 0, 0)), ((4, 6, 6), (2, 3, 3), (0, 1, 1))])
def test_shift_mask_matches_jax(dims, window, shift):
    got = compute_shift_mask(*dims, window, shift)
    want = jax_shift_mask(*dims, window, shift)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_window_clamping():
    assert get_window_size((2, 3, 3), (8, 7, 7), (4, 3, 3)) == ((2, 3, 3),
                                                                (0, 0, 0))
    assert get_window_size((16, 56, 56), (8, 7, 7)) == (8, 7, 7)


def test_drop_path_masks_whole_samples():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, 3, 2)
    assert drop_path(x, 0.5, False, gen) is x
    assert drop_path(x, 0.0, True, gen) is x
    y = drop_path(x, 0.5, True, gen)
    per_sample = y.reshape(64, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 2.0).all(1)).all()
    assert 0 < int((per_sample == 0).all(1).sum()) < 64


def test_get_model_builds_swin():
    model = get_model(_cfg(swin_ucf101_preset))
    assert isinstance(model, Recognizer3D)
    assert len(model.backbone.layers) == 4


def test_eval_step_matches_jax_engine(models):
    oracle, jm, variables, _pm = models
    _, aux = jm.apply(variables, jnp.asarray(_clip(7)), train=False,
                      mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"]).items()}
    jeng = JaxEngine(jm, _cfg(jax_preset), variables, src, donate=False)
    cfg = _cfg(swin_ucf101_preset)
    eng = VittaEngine(get_model(cfg), cfg, oracle.state_dict(), src,
                      device="cpu")
    assert eng.tap_names == tuple(jeng.tap_names) and eng.tap_names
    rng = np.random.default_rng(11)
    for i in range(3):
        clip = rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8)
        label = np.asarray([i % K], np.int32)
        jt1, jt5, jpred = jeng.eval_step(jeng.init_params, jnp.asarray(clip),
                                         jnp.asarray(label))
        t1, t5, pred = eng.eval_step(eng.init_params, clip, label)
        assert float(t1) == float(jt1) and float(t5) == float(jt5)
        assert pred.tolist() == np.asarray(jpred).tolist()
        want = np.asarray(jm.apply(
            variables, (jnp.asarray(clip, jnp.float32)
                        - jnp.asarray(cfg.data.input_mean))
            / jnp.asarray(cfg.data.input_std), train=False))
        np.testing.assert_allclose(eng.eval_logits(clip).numpy(), want,
                                   rtol=2e-3, atol=2e-4)
