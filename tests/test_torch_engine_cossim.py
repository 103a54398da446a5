"""3-step trajectories of the port's engine under ``stat_reg="cossim"``
against the JAX ``VittaEngine``: the tiny TANet of
tests/torch_engine_modes.py at T = 4 (six frame pairs per layer, so the pair
order matters) with ``l1_loss`` and ``mse_loss``, and the tiny Video Swin of
tests/test_torch_swin_engine.py.  The relation-map targets come from one
tapped JAX forward of a seeded clean clip; a None entry (a layer without a
map) must be skipped.

Tolerances are those of the two files named: losses and the EMA rtol 1e-3 /
atol 1e-5, each tensor's update to 2% of its norm, eval logits of the Swin
rtol 2e-3 / atol 2e-4, predictions exactly.  Under ``l1_loss`` the gradient
of |sim - target| is a sign: a layer whose similarity sits on its target to
rounding would flip it, which the seeded videos (far from the clean clip)
do not do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_swin_engine as se
from tests import torch_engine_modes as tm
from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import swin_ucf101_preset as jax_swin_preset
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models.swin import Recognizer3D

torch.set_num_threads(1)

T = 4
COSSIM = dict(stat_reg="cossim", stat_type=("temp",))


@pytest.fixture(scope="module")
def weights():
    sd, variables = tm.tanet_weights(T)
    src = {n: np.asarray(s.mean) for n, s in tm.jax_taps(
        variables, T, ("cossim",), "cossim", bn1d=True).items()}
    # the file layout's placeholder at a layer without a map
    src["base_model.layer3_0.tam.g_bn"] = None
    return sd, variables, src


@pytest.mark.parametrize("reg_type", ["l1_loss", "mse_loss"])
def test_tanet_cossim_trajectory_matches_jax(weights, reg_type):
    sd, variables, src = weights
    jeng, eng = tm.engines(sd, variables, src, T, reg_type=reg_type, **COSSIM)
    # layer3 and layer4: 29 BatchNorm2d and the 9 l_bn of their TAMs (rank
    # 3); the g_bn features are rank 2 and have no map
    assert eng.tap_names == tuple(jeng.tap_names) and len(eng.tap_names) == 38
    assert eng.reg_specs[0].leaf == "stat_cossim"
    assert all(s.mean.shape == (6,) and not s.var.any()
               for s in eng.reg_specs[0].source.values())
    _state, _jstate, moved = tm.run_trajectories(jeng, eng, T, sd)
    assert moved >= 100


def test_cossim_needs_targets(weights):
    sd, _variables, _src = weights
    cfg = tm.cfg_of(tm.tanet_ucf101_preset, T, **COSSIM)
    with pytest.raises(ValueError, match="relation-map targets"):
        VittaEngine(tm.get_model(cfg), cfg, sd, None, device="cpu")


def test_cossim_before_norm_reads_the_input_side(weights):
    sd, _variables, src = weights
    cfg = tm.cfg_of(tm.tanet_ucf101_preset, T, before_norm=True, **COSSIM)
    eng = VittaEngine(tm.get_model(cfg), cfg, sd, src, device="cpu")
    assert eng.reg_specs[0].leaf == "stat_in_cossim"
    views, clip, label = tm.videos(T, 1)[0]
    _state, m = eng.adapt_eval_step(eng.init_state(), views, clip, label)
    assert np.isfinite(float(m.loss_reg)) and float(m.loss_reg) > 0


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def swin_weights():
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(se.K, se.PATCH, se.EMBED, se.DEPTHS, se.HEADS,
                               se.WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, se.K, depths=se.DEPTHS,
                                        window_size=se.WINDOW)
    clean = np.random.default_rng(100).normal(
        size=(se.V, se.T, se.HW, se.HW, 3)).astype(np.float32)
    _, aux = JaxRecognizer3D(drop_path_rate=0.0, stat_types=("cossim",),
                             **se.MODEL_KW).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    src = {n: np.asarray(s.mean)
           for n, s in jax_flatten_taps(aux["taps"], "stat_cossim").items()}
    return sd, variables, src


def test_swin_cossim_trajectory_matches_jax(swin_weights):
    sd, variables, src = swin_weights
    jmodel = JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                             stat_types=("cossim",), **se.MODEL_KW)
    jeng = JaxEngine(jmodel, se._cfg(jax_swin_preset, **COSSIM), variables,
                     src, donate=False)
    model = Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                         stat_types=("cossim",), **se.MODEL_KW)
    eng = VittaEngine(model, se._cfg(swin_ucf101_preset, **COSSIM), sd, src,
                      device="cpu")
    assert eng.tap_names == tuple(jeng.tap_names) and len(eng.tap_names) == 8
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, (views, clip, label) in enumerate(se._videos()):
        jstate, jm = jeng.adapt_eval_step(
            jstate, jnp.asarray(views), jnp.asarray(clip), jnp.asarray(label),
            jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            np.testing.assert_allclose(
                float(getattr(m, field)), float(getattr(jm, field)),
                rtol=se.RTOL, atol=se.ATOL, err_msg=f"{field} step {i}")
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
        np.testing.assert_allclose(
            eng.eval_logits(clip).numpy(),
            np.asarray(jeng._apply_eval(jstate.params, jnp.asarray(clip))),
            rtol=2e-3, atol=2e-4, err_msg=f"eval logits step {i}")
        tm.assert_ema_close(state.ema, jstate.ema)
        se._compare_params(eng, jstate, sd, step=i)
    assert state.step == se.N_STEPS
