"""3-step ViTTA trajectories of the port's engine on Video Swin against the
JAX ``VittaEngine``, from the same weights, source statistics and uint8
videos: the tiny config of tests/test_torch_swin.py (shifted, clamped and
padded windows), drop-path and head dropout 0 so that no random numbers
enter.  On the CPU the port's four Swin ops take their plain versions under
torch autograd and the JAX package its jnp paths, so this file holds the
slice as a whole (model, taps, losses, optimizer, carried state) to the
reference; the kernels' own backward math is in
tests/test_torch_swin_backward.py.

Tolerances, and why (tests/test_torch_engine.py's, for the same reasons):
* losses and the EMA: rtol 1e-3 / atol 1e-5.  Float32 products summed in
  different orders through six blocks; three SGD steps on slightly
  different gradients move the two a little further apart.
* eval logits: rtol 2e-3 / atol 2e-4, tests/test_torch_swin.py's bound.
* weights: lr is raised to 1e-3 so that three steps move the weights far
  above float32 rounding; each tensor's update then agrees with the JAX
  update to 2% of its norm, leaf by leaf under
  ``swin_state_dict_from_jax``'s name mapping.
* predictions and top-1/top-5: exactly.
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
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.adapt.loops import tta_stream
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.utils.checkpoint import swin_state_dict_from_jax

torch.set_num_threads(1)

K = 6
DEPTHS = (1, 1, 2, 1)
EMBED = 8
HEADS = (1, 2, 4, 8)
WINDOW = (2, 3, 3)
PATCH = (2, 4, 4)
T, HW, V = 4, 24, 2
MODEL_KW = dict(num_classes=K, patch_size=PATCH, window_size=WINDOW,
                embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS)
LR = 1e-3
RTOL, ATOL = 1e-3, 1e-5
N_STEPS = 3

MODES = {   # name: tta overrides
    "online": dict(),
    "standard": dict(if_tta_standard="tta_standard", momentum_mvg=1.0,
                     n_gradient_steps=2),
}


def _cfg(preset, **tta):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, drop_path_rate=0.0, **MODEL_KW),
        optim=dataclasses.replace(cfg.optim, lr=LR),
        tta=dataclasses.replace(cfg.tta, **tta))


@pytest.fixture(scope="module")
def weights():
    """(reference-keyed state dict, JAX variables, source statistics)."""
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(K, PATCH, EMBED, DEPTHS, HEADS, WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, K, depths=DEPTHS,
                                        window_size=WINDOW)
    clean = np.random.default_rng(100).normal(
        size=(V, T, HW, HW, 3)).astype(np.float32)
    _, aux = JaxRecognizer3D(drop_path_rate=0.0, **MODEL_KW).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"]).items()}
    return sd, variables, src


def _videos(n=N_STEPS):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
             np.asarray([i % K], np.int32)) for i in range(n)]


def _port_engine(weights, drop_path_rate=0.0, head_dropout=0.0, **tta):
    sd, _variables, src = weights
    model = Recognizer3D(drop_path_rate=drop_path_rate,
                         head_dropout=head_dropout, **MODEL_KW)
    return VittaEngine(model, _cfg(swin_ucf101_preset, **tta), sd, src,
                       device="cpu")


def test_chosen_taps_are_the_last_two_stages_and_the_final_norm(weights):
    eng = _port_engine(weights)
    # layers_2: 2 blocks x 2 norms + the downsample norm; layers_3: 1 x 2;
    # backbone.norm
    assert len(eng.tap_names) == 8
    assert all(n.startswith(("backbone.layers_2", "backbone.layers_3",
                             "backbone.norm")) for n in eng.tap_names)


@pytest.mark.parametrize("mode", list(MODES))
def test_trajectory_matches_jax(weights, mode):
    sd, variables, src = weights
    tta = MODES[mode]
    jmodel = JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0, **MODEL_KW)
    jeng = JaxEngine(jmodel, _cfg(jax_preset, **tta), variables, src,
                     donate=False)
    eng = _port_engine(weights, **tta)
    assert eng.tap_names == tuple(jeng.tap_names)
    jstate, state = jeng.init_state(), eng.init_state()
    rng = jax.random.PRNGKey(0)
    for i, (views, clip, label) in enumerate(_videos()):
        jstate, jm = jeng.adapt_eval_step(jstate, jnp.asarray(views),
                                          jnp.asarray(clip),
                                          jnp.asarray(label),
                                          jax.random.fold_in(rng, i))
        state, m = eng.adapt_eval_step(state, views, clip, label)
        for field in ("loss_reg", "loss_consis", "loss_ce"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jm, field)), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{field} step {i}")
        for field in ("top1", "top5"):
            assert float(getattr(m, field)) == float(getattr(jm, field))
        assert m.pred.tolist() == np.asarray(jm.pred).tolist()
        if mode == "standard":
            continue   # the JAX state after a tta_standard step is the reset one
        np.testing.assert_allclose(
            eng.eval_logits(clip).numpy(),
            np.asarray(jeng._apply_eval(jstate.params, jnp.asarray(clip))),
            rtol=2e-3, atol=2e-4, err_msg=f"eval logits step {i}")
        assert set(state.ema) == set(jstate.ema) and state.ema
        for name, stats in state.ema.items():
            for g, w in zip(stats, jstate.ema[name]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                           atol=ATOL, err_msg=f"ema {name}")
        _compare_params(eng, jstate, sd, step=i)
    assert state.step == N_STEPS


def _compare_params(eng, jstate, sd, step):
    """Every parameter against the JAX engine's, as updates from the
    common initial weights."""
    want = swin_state_dict_from_jax({"params": jstate.params}, depths=DEPTHS,
                                    window_size=WINDOW)
    got = dict(eng.model.named_parameters())
    assert set(got) <= set(want)
    moved = 0
    for k, p in got.items():
        init = sd[k].numpy()
        dj, dp = want[k].numpy() - init, p.detach().numpy() - init
        assert np.linalg.norm(dp - dj) <= 2e-2 * np.linalg.norm(dj) + 1e-8, (
            f"{k} step {step}")
        moved += np.linalg.norm(dj) > 0
    # the relative-position tables included: the bias gradient is used
    assert moved == len(got)


def test_standard_mode_resets_per_video(weights):
    eng = _port_engine(weights, **MODES["standard"])
    views, clip, label = _videos(1)[0]
    state = eng.init_state()
    state, m1 = eng.adapt_eval_step(state, views, clip, label)
    state, m2 = eng.adapt_eval_step(state, views, clip, label)
    assert float(m1.loss_reg) == float(m2.loss_reg)
    assert float(m1.loss_consis) == float(m2.loss_consis)


def test_drop_path_and_head_dropout_draw_from_engine_generator(weights):
    eng = _port_engine(weights, drop_path_rate=0.5, head_dropout=0.5)
    views, clip, label = _videos(1)[0]
    global_rng = torch.get_rng_state()

    def run(seed):
        state = eng.init_state()
        eng.generator.manual_seed(seed)
        _, m = eng.adapt_eval_step(state, views, clip, label)
        return float(m.loss_consis), float(m.loss_reg)

    first, again, other = run(1), run(1), run(2)
    assert first == again
    assert first != other              # the masks move taps and logits
    assert torch.equal(torch.get_rng_state(), global_rng)
    # and with both rates 0 the generator is not read at all
    plain = _port_engine(weights)
    plain.generator.manual_seed(5)
    before = plain.generator.get_state()
    plain.adapt_eval_step(plain.init_state(), views, clip, label)
    assert torch.equal(plain.generator.get_state(), before)


def test_drop_path_only_moves_the_step(weights):
    """Drop-path alone (head dropout 0) changes the adapt step's losses and
    leaves the eval forward, which runs with ``train=False``, untouched."""
    views, clip, label = _videos(1)[0]
    plain = _port_engine(weights)
    dropped = _port_engine(weights, drop_path_rate=0.5)
    torch.testing.assert_close(plain.eval_logits(clip),
                               dropped.eval_logits(clip), rtol=0, atol=0)
    dropped.generator.manual_seed(3)
    _, m0 = plain.adapt_eval_step(plain.init_state(), views, clip, label)
    _, m1 = dropped.adapt_eval_step(dropped.init_state(), views, clip, label)
    assert float(m0.loss_reg) != float(m1.loss_reg)


def test_tta_stream_is_reproducible(weights):
    eng = _port_engine(weights, drop_path_rate=0.5, head_dropout=0.5)
    data = _videos()
    top1_a, _, meters_a = tta_stream(eng, data, seed=3)
    top1_b, state, meters_b = tta_stream(eng, data, seed=3)
    assert state.step == len(data)
    assert top1_a == top1_b
    for k in ("loss_reg", "loss_consis", "loss_ce"):
        assert meters_a[k].avg == meters_b[k].avg
        assert np.isfinite(meters_a[k].avg)
    _, _, meters_c = tta_stream(eng, data, seed=4)
    assert meters_c["loss_reg"].avg != meters_a["loss_reg"].avg
