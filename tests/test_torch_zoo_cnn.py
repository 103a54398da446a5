"""The port's BatchNorm CNNs of the model zoo against vitta_tpu's on the CPU:
R(2+1)D-18, I3D-ResNet 18 and 50, Inception-I3D and TANet without the TAM,
every one at its real widths, from the same seeded weights
(tests/torch_zoo.py) carried across by the ``*_state_dict_from_jax``
functions; vitta_tpu runs op by op (``apply`` outside ``jit``).

Tolerances, and why:
* logits and every tap (both sides, means and variances; count leaves
  exactly): rtol 2e-3 / atol 2e-4, tests/test_tanet_parity.py's: float32
  conv stacks up to 50 layers deep that sum in other orders (oneDNN
  against XLA:CPU).
* ``Conv2Plus1D``'s gradients (input, weights, the BatchNorm's affine,
  through its output statistics): atol 2e-4 of each gradient's largest
  value, rtol 2e-3.
* 3-step ``tta_online`` trajectories (lr 1e-2 so that the weights move far
  above float32 rounding, dropout off), tests/test_torch_engine.py's
  bounds: losses and EMA rtol 1e-3 / atol 1e-5, predictions and top-1 /
  top-5 exactly, each tensor's update within 2% of the JAX update's norm,
  running statistics rtol 1e-3 / atol 5e-5.
* the CLI's ``evaluate`` of R(2+1)D: top-1 equal.
"""

import numpy as np
import pytest
import torch

from tests import torch_zoo as tz
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.cli import main_eval as jax_main_eval
from vitta_tpu.cli.opts import get_opts as jax_get_opts
from vitta_tpu.models.i3d import I3D as JaxI3D
from vitta_tpu.models.i3d_incep import InceptionI3d as JaxInception
from vitta_tpu.models.r2plus1d import Conv2Plus1D as JaxConv2Plus1D
from vitta_tpu.models.r2plus1d import R2Plus1D as JaxR2Plus1D
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.cli import main_eval
from vitta_tpu_torch.cli.opts import get_opts
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models.i3d import I3D
from vitta_tpu_torch.models.i3d_incep import InceptionI3d, same_padding
from vitta_tpu_torch.models.layers import flatten_taps
from vitta_tpu_torch.models.r2plus1d import Conv2Plus1D, R2Plus1D
from vitta_tpu_torch.models.tanet import TANet
from vitta_tpu_torch.utils.checkpoint import (
    i3d_incep_state_dict_from_jax, i3d_state_dict_from_jax,
    load_reference_stats, r2plus1d_state_dict_from_jax, save_stats,
    state_dict_from_flax, tanet_norm_layers, tanet_state_dict_from_jax)

torch.set_num_threads(1)

K, HW = 5, 32
RTOL, ATOL = 2e-3, 2e-4
STEP_RTOL, STEP_ATOL, UPDATE_REL = 1e-3, 1e-5, 2e-2

# name: (JAX model, port model, converter, clip frames, tap layers)
MODELS = {
    "r2plus1d": (lambda: JaxR2Plus1D(num_classes=K), lambda: R2Plus1D(K),
                 r2plus1d_state_dict_from_jax, 4, 37),
    "i3d_resnet18": (lambda: JaxI3D(num_classes=K, depth=18),
                     lambda: I3D(K, depth=18), i3d_state_dict_from_jax, 4,
                     20),
    "i3d_resnet50": (lambda: JaxI3D(num_classes=K, depth=50),
                     lambda: I3D(K, depth=50), i3d_state_dict_from_jax, 4,
                     53),
    "i3d_incep": (lambda: JaxInception(num_classes=K),
                  lambda: InceptionI3d(K), i3d_incep_state_dict_from_jax, 8,
                  57),
    "tanet_no_tam": (lambda: JaxTANet(num_classes=K, clip_length=4,
                                      use_tam=False),
                     lambda: TANet(K, clip_length=4, use_tam=False),
                     tanet_state_dict_from_jax, 4, 53),
}


@pytest.fixture(scope="module")
def weights():
    """{name: (JAX model, variables, port state dict)}, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jfn, _pfn, convert, t, _n = MODELS[name]
            jmodel = jfn()
            variables = tz.seeded_variables(jmodel, tz.clip(0, 2, t, HW))
            cache[name] = (jmodel, variables, convert(variables))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_and_taps_match_vitta_tpu(weights, name):
    _jfn, pfn, _convert, t, n_layers = MODELS[name]
    jmodel, variables, sd = weights(name)
    port = pfn()
    port.load_state_dict(sd, strict=True)
    x = tz.clip(1, 2, t, HW)
    want, aux = jmodel.apply(variables, x, train=False, mutable=["taps"])
    taps = {}
    with torch.no_grad():
        got = port(torch.from_numpy(x), taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert tz.assert_taps_match(taps, aux, RTOL, ATOL) == n_layers


def test_tanet_without_tam_agrees_with_its_files():
    """No ``tam.*`` keys, no BatchNorm1d layer; ``tanet_norm_layers`` and
    ``load_reference_stats`` name exactly the model's BatchNorms."""
    model = TANet(K, clip_length=4, use_tam=False)
    assert not [k for k in model.state_dict() if ".tam." in k]
    layers = tanet_norm_layers(use_tam=False)
    assert {kind for _, kind in layers} == {"bn2d"}
    taps = {}
    with torch.no_grad():
        model(torch.zeros(1, 4, HW, HW, 3), taps)
    assert sorted(taps) == sorted(n for n, _ in layers)
    assert len(TANet(K, clip_length=4).state_dict()) > len(model.state_dict())


def test_tanet_without_tam_statistics_files(tmp_path):
    names = [n for n, _ in tanet_norm_layers(use_tam=False)]
    stats = {n: (np.full(4, i, np.float32), np.ones(4, np.float32))
             for i, n in enumerate(names)}
    m, v = tmp_path / "m.npy", tmp_path / "v.npy"
    save_stats(m, v, stats, "tanet", use_tam=False)
    back = load_reference_stats(m, v, "tanet", use_tam=False)
    assert list(back) == names and float(back[names[7]][0][0]) == 7.0
    with pytest.raises(ValueError, match="norm layers"):
        load_reference_stats(m, v, "tanet", use_tam=True,
                             include_bn1d=True)


def test_conv2plus1d_forward_and_gradients_match_vitta_tpu():
    """One factored conv (64 -> 128, stride 2: midplanes 230, which takes
    the BatchNorm-statistics kernels' one-column instance on the card),
    its BatchNorm's output statistics in the loss."""
    jmod = JaxConv2Plus1D(128, (2, 2, 2))
    x = np.random.default_rng(2).normal(size=(2, 4, 8, 8, 64)).astype(
        np.float32)
    variables = tz.seeded_variables(jmod, x, use_running_average=True)
    rng = np.random.default_rng(4)
    cot = rng.normal(size=(2, 2, 4, 4, 128)).astype(np.float32)
    cot_m = rng.normal(size=(230,)).astype(np.float32)

    import jax
    import jax.numpy as jnp

    def loss(params, xx):
        out, aux = jmod.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              xx, mutable=["taps"])
        m = aux["taps"]["bn_mid"]["stat"].mean
        return jnp.sum(out * cot) + jnp.sum(m * cot_m), out

    (want_l, want), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    port = Conv2Plus1D(64, 128, "", stride=(2, 2, 2))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    taps = {}
    out = port(xt, taps)
    m = flatten_taps(taps)[".bn_mid"].mean
    (torch.sum(out * torch.from_numpy(cot))
     + torch.sum(m * torch.from_numpy(cot_m))).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    grads = state_dict_from_flax({"params": gp, "batch_stats":
                                  variables["batch_stats"]})
    pairs = [("x", xt.grad, np.asarray(gx))] + [
        (k, p.grad, grads[k].numpy()) for k, p in port.named_parameters()]
    for name, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


def test_same_padding_is_tensorflows():
    """Odd totals put the extra element after the input; stride 1 keeps
    the size (vitta_tpu relies on XLA's padding="SAME")."""
    assert same_padding((16, 224, 224), (7, 7, 7), (2, 2, 2)) == \
        [(2, 3), (2, 3), (2, 3)]
    assert same_padding((8, 112, 112), (1, 3, 3), (1, 2, 2)) == \
        [(0, 0), (0, 1), (0, 1)]
    assert same_padding((8, 28, 28), (3, 3, 3), (1, 1, 1)) == [(1, 1)] * 3
    assert same_padding((3, 7, 7), (2, 2, 2), (2, 2, 2)) == [(0, 1)] * 3


@pytest.mark.parametrize("arch,chosen,n_chosen,tta", [
    ("r2plus1d", ("layer3", "layer4"), 18, {}),
    ("i3d_resnet18", ("layer3", "layer4"), 10, {"stat_reg": "BNS"}),
])
def test_trajectory_matches_vitta_tpu(weights, arch, chosen, n_chosen, tta):
    """3 ``tta_online`` steps under ``mean_var`` (R(2+1)D) and BNS
    (I3D-18)."""
    jmodel, variables, sd = weights(arch)
    t = MODELS[arch][3]
    jcfg, cfg = tz.zoo_cfgs(arch, t, HW, K, chosen, **tta)
    src = (None if tta.get("stat_reg") == "BNS"
           else tz.source_stats(jmodel, variables, t, HW))
    if arch.startswith("i3d"):
        jmodel = JaxI3D(num_classes=K, depth=18, dropout=0.0)
        model = I3D(K, depth=18, dropout=0.0)
    else:
        model = get_model(cfg)
    jeng = JaxEngine(jmodel, jcfg, variables, src, donate=False)
    eng = VittaEngine(model, cfg, sd, src, device="cpu")
    assert len(eng.tap_names) == n_chosen
    moved = tz.assert_trajectories_match(
        jeng, eng, tz.uint8_videos(3, t, HW, K), sd, MODELS[arch][2],
        STEP_RTOL, STEP_ATOL, UPDATE_REL)
    assert moved >= 0.9 * sum(1 for _ in model.parameters())


def test_cli_evaluate_r2plus1d_top1_matches_vitta_tpu(tmp_path,
                                                      monkeypatch):
    """``--arch r2plus1d --tta False`` (the source model) through both
    packages' ``config_from_args`` and ``evaluate`` at T=4, 32 x 32 crops
    of 40, on the same weights (101 classes); the list's labels are the
    model's own predictions but one's, so top-1 is 2/3."""
    variables = tz.seeded_variables(JaxR2Plus1D(num_classes=101),
                                    tz.clip(0, 1, 4, HW), seed=5)
    sd = r2plus1d_state_dict_from_jax(variables)
    monkeypatch.setattr(jax_main_eval, "load_variables",
                        lambda cfg, model, seed=0: variables)
    monkeypatch.setattr(main_eval, "load_variables",
                        lambda cfg, seed=0: sd)
    monkeypatch.setenv("VITTA_PLATFORM", "cpu")
    listing = tmp_path / "list.txt"
    listing.write_text("".join(f"vid_{i} {44 + 4 * i} 0\n" for i in range(3)))
    argv = ["--arch", "r2plus1d", "--tta", "false", "--clip_length", "4",
            "--input_size", "32", "--scale_size", "40", "--video_source",
            "synthetic", "--workers", "1", "--val_vid_list", str(listing)]
    _a, cfg = get_opts(argv + ["--result_dir", str(tmp_path / "probe")])
    assert cfg.model.arch == "r2plus1d" and cfg.model.num_classes == 101
    model = get_model(cfg)
    model.load_state_dict(sd, strict=True)
    preds = []
    for sample in main_eval.make_datasets(cfg, "synthetic",
                                          emit_uint8=False).eval:
        with torch.no_grad():
            preds.append(int(model(torch.from_numpy(sample.frames),
                                   None).mean(0).argmax()))
    preds[-1] = (preds[-1] + 1) % 101
    listing.write_text("".join(f"vid_{i} {44 + 4 * i} {p}\n"
                               for i, p in enumerate(preds)))
    _a, jcfg = jax_get_opts(argv + ["--result_dir", str(tmp_path / "jax")])
    _a, cfg = get_opts(argv + ["--result_dir", str(tmp_path / "port")])
    want, _ = jax_main_eval.evaluate(jcfg, "gauss", source_kind="synthetic")
    got, state = main_eval.evaluate(cfg, "gauss", source_kind="synthetic")
    assert state is None
    assert got == want == [100.0 * 2 / 3]


def test_zoo_archs_build_and_refuse_checkpoints_and_statistics_files(
        tmp_path):
    """``get_model`` and ``config_from_args`` build every arch of the zoo;
    a checkpoint path and a statistics file raise for them, as in
    vitta_tpu."""
    for arch, cls in (("r2plus1d", R2Plus1D), ("i3d_resnet18", I3D),
                      ("i3d_resnet50", I3D), ("i3d_incep", InceptionI3d)):
        _a, cfg = get_opts(["--arch", arch, "--model_path", "x.pth"])
        assert isinstance(get_model(cfg), cls)
        with pytest.raises(NotImplementedError, match="checkpoints load"):
            main_eval.load_variables(cfg)
        with pytest.raises(NotImplementedError, match="statistics files"):
            save_stats(tmp_path / "m.npy", tmp_path / "v.npy", {}, arch)
    assert len(I3D(K, depth=50).backbone.layer4_0.bn3.weight) == 2048


@pytest.mark.parametrize("name", ["r2plus1d", "i3d_resnet18", "i3d_incep"])
def test_norm_affine_mask_matches_vitta_tpus(weights, name):
    """``update_only_bn_affine`` trains the same norm layers' weight and
    bias as vitta_tpu's ``norm_affine_mask`` (R(2+1)D's bn1, bn2 and
    downsample_bn, not its bn_mid or stem)."""
    import jax
    from vitta_tpu.adapt.optim import norm_affine_mask as jax_mask
    from vitta_tpu_torch.adapt.optim import norm_affine_mask
    _jmodel, variables, _sd = weights(name)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    want = {".".join(p.key for p in path[:-1]) + "." + leaf[path[-1].key]: m
            for path, m in jax.tree_util.tree_flatten_with_path(
                jax_mask(variables["params"]))[0]}
    got = norm_affine_mask(MODELS[name][1]().named_parameters())
    # vitta_tpu's list of norm names has no Inception "bn": Adam on the
    # norm affine trains nothing there, in either package
    assert got == want and any(got.values()) == (name != "i3d_incep")

