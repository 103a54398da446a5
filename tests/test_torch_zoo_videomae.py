"""The port's VideoMAE against vitta_tpu's on the CPU, and the reference
checkpoint converters of the model zoo.

VideoMAE at embed 64, depth 2, heads 2 (and one case at ViT-B's width,
768, 12 heads, depth 1) from seeded weights (tests/torch_zoo.py) carried
across by ``videomae_state_dict_from_jax``; vitta_tpu runs op by op.

Tolerances, and why:
* ``ViTBlock``'s output and gradients (input, every parameter): rtol 2e-3,
  atol 2e-4 of each tensor's largest value: float32 products over up to 4C
  terms and a softmax, summed in other orders (oneDNN against XLA:CPU).
* logits and every tap (25 LayerNorm sides at ViT-B's depth, here 5 and 3;
  means and variances; count leaves exactly): rtol 2e-3 / atol 2e-4, as
  tests/test_torch_swin.py.
* a 3-step ``tta_online`` trajectory (drop path off, lr 1e-2 so that the
  weights move far above float32 rounding), tests/test_torch_engine.py's
  bounds: losses and EMA rtol 1e-3 / atol 1e-5, predictions and top-1 /
  top-5 exactly, each tensor's update within 2% of the JAX update's norm.
* the converters: equal, value for value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests import torch_zoo as tz
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.models.videomae import VideoMAE as JaxVideoMAE
from vitta_tpu.models.videomae import ViTBlock as JaxViTBlock
from vitta_tpu.utils.checkpoint import (convert_videomae_checkpoint,
                                        inflate_swin2d_checkpoint)
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.models.videomae import VideoMAE, ViTBlock
from vitta_tpu_torch.utils.checkpoint import (inflate_swin2d_state_dict,
                                              state_dict_from_flax,
                                              swin_state_dict_from_jax,
                                              videomae_state_dict,
                                              videomae_state_dict_from_jax)

torch.set_num_threads(1)

K, T, HW = 5, 4, 32
RTOL, ATOL = 2e-3, 2e-4
STEP_RTOL, STEP_ATOL, UPDATE_REL = 1e-3, 1e-5, 2e-2
SMALL = dict(embed_dim=64, depth=2, num_heads=2)


def _pair(seed=0, **kw):
    jmodel = JaxVideoMAE(num_classes=K, **kw)
    variables = tz.seeded_variables(jmodel, tz.clip(0, 2, T, HW), seed=seed)
    return jmodel, variables, videomae_state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def small():
    return _pair(**SMALL, drop_path_rate=0.0)


def test_vit_block_forward_and_gradients_match_vitta_tpu():
    dim, heads, n = 64, 4, 24
    jblock = JaxViTBlock(dim, heads)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, n, dim)).astype(np.float32)
    cot = rng.normal(size=(2, n, dim)).astype(np.float32)
    variables = tz.seeded_variables(jblock, x, deterministic=True)

    def loss(params, xx):
        out, aux = jblock.apply({"params": params}, xx, mutable=["taps"])
        m = aux["taps"]["norm2"]["stat"].mean
        return jnp.sum(out * cot) + jnp.sum(m), out

    (_l, want), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    block = ViTBlock(dim, heads, "")
    block.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    taps = {}
    out = block(xt, taps)
    (torch.sum(out * torch.from_numpy(cot))
     + torch.sum(taps[".norm2"]["stat"].mean)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    grads = state_dict_from_flax({"params": gp})
    assert set(grads) == {k for k, _ in block.named_parameters()}
    pairs = [("x", xt.grad, np.asarray(gx))] + [
        (k, p.grad, grads[k].numpy()) for k, p in block.named_parameters()]
    for name, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("width", ["small", "vit_b_width"])
def test_logits_and_taps_match_vitta_tpu(small, width):
    if width == "small":
        jmodel, variables, sd = small
        port = VideoMAE(K, **SMALL)
    else:   # ViT-B's width and heads, one block
        kw = dict(embed_dim=768, depth=1, num_heads=12)
        jmodel, variables, sd = _pair(seed=1, **kw)
        port = VideoMAE(K, **kw)
    port.load_state_dict(sd, strict=True)
    x = tz.clip(1, 2, T, HW)
    want, aux = jmodel.apply(variables, x, train=False, mutable=["taps"])
    taps = {}
    with torch.no_grad():
        got = port(torch.from_numpy(x), taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    n = 2 * len(port.blocks) + 1
    assert tz.assert_taps_match(taps, aux, RTOL, ATOL) == n


def test_trajectory_matches_vitta_tpu(small):
    """3 ``tta_online`` steps under ``mean_var`` with ``chosen_blocks``
    ("norm",): every LayerNorm."""
    jmodel, variables, sd = small
    jcfg, cfg = tz.zoo_cfgs("videomae", T, HW, K, ("norm",))
    src = tz.source_stats(jmodel, variables, T, HW)
    jeng = JaxEngine(jmodel, jcfg, variables, src, donate=False)
    eng = VittaEngine(VideoMAE(K, **SMALL, drop_path_rate=0.0), cfg, sd, src,
                      device="cpu")
    assert len(eng.tap_names) == 5
    moved = tz.assert_trajectories_match(
        jeng, eng, tz.uint8_videos(3, T, HW, K), sd,
        videomae_state_dict_from_jax, STEP_RTOL, STEP_ATOL, UPDATE_REL)
    assert moved >= 0.9 * len(sd)


def test_get_model_builds_vit_b():
    _jcfg, cfg = tz.zoo_cfgs("videomae", 16, 224, 101, ("norm",))
    model = get_model(cfg)
    assert isinstance(model, VideoMAE) and len(model.blocks) == 12
    assert model.blocks[0].mlp.fc1.weight.shape == (3072, 768)
    assert model.blocks[11].drop_path == pytest.approx(0.1)


class _TimmBlock(nn.Module):
    def __init__(self, d, split_bias):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(d), nn.LayerNorm(d)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(d, 3 * d, bias=not split_bias)
        if split_bias:
            self.attn.q_bias = nn.Parameter(torch.randn(d))
            self.attn.v_bias = nn.Parameter(torch.randn(d))
        self.attn.proj = nn.Linear(d, d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, 4 * d)
        self.mlp.fc2 = nn.Linear(4 * d, d)


class _TimmViT(nn.Module):
    """timm's VideoMAE key layout (tests/test_model_zoo.py:76's module),
    with the split q / v biases and ``fc_norm`` where asked."""

    def __init__(self, d, depth, split_bias, fc_norm):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(3, d, (2, 16, 16), (2, 16, 16))
        self.blocks = nn.ModuleList(_TimmBlock(d, split_bias)
                                    for _ in range(depth))
        if fc_norm:
            self.fc_norm = nn.LayerNorm(d)
        else:
            self.norm = nn.LayerNorm(d)
        self.head = nn.Linear(d, K)


@pytest.mark.parametrize("split_bias,fc_norm", [(False, False),
                                                (True, True)])
def test_videomae_converter_matches_vitta_tpus(split_bias, fc_norm):
    torch.manual_seed(0)
    ref = _TimmViT(32, 2, split_bias, fc_norm).state_dict()
    ref = {"model": {f"module.{k}": v for k, v in ref.items()}}
    want = videomae_state_dict_from_jax(
        convert_videomae_checkpoint(ref, K, depth=2))
    got = videomae_state_dict(ref, depth=2)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    VideoMAE(K, embed_dim=32, depth=2, num_heads=2).load_state_dict(
        got, strict=True)


def _image_swin(embed, depths, heads, window, num_classes=7):
    """An image Swin's state dict (keys of SwinTransformer/Swin-Transformer
    models/swin_transformer.py), random values."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    sd = {"patch_embed.proj.weight": r(embed, 3, 4, 4),
          "patch_embed.proj.bias": r(embed),
          "patch_embed.norm.weight": r(embed),
          "patch_embed.norm.bias": r(embed)}
    for li, (d, nh) in enumerate(zip(depths, heads)):
        c = embed * 2 ** li
        for bi in range(d):
            p = f"layers.{li}.blocks.{bi}"
            for name, shape in (("norm1", (c,)), ("norm2", (c,))):
                sd[f"{p}.{name}.weight"] = r(*shape)
                sd[f"{p}.{name}.bias"] = r(*shape)
            sd[f"{p}.attn.relative_position_bias_table"] = r(
                (2 * window - 1) ** 2, nh)
            sd[f"{p}.attn.relative_position_index"] = torch.zeros(
                window ** 2, window ** 2, dtype=torch.long)
            for name, (o, i) in (("attn.qkv", (3 * c, c)),
                                 ("attn.proj", (c, c)),
                                 ("mlp.fc1", (4 * c, c)),
                                 ("mlp.fc2", (c, 4 * c))):
                sd[f"{p}.{name}.weight"] = r(o, i)
                sd[f"{p}.{name}.bias"] = r(o)
        if li < len(depths) - 1:
            sd[f"layers.{li}.downsample.reduction.weight"] = r(2 * c, 4 * c)
            sd[f"layers.{li}.downsample.norm.weight"] = r(4 * c)
            sd[f"layers.{li}.downsample.norm.bias"] = r(4 * c)
    c = embed * 2 ** (len(depths) - 1)
    sd["norm.weight"], sd["norm.bias"] = r(c), r(c)
    sd["head.weight"], sd["head.bias"] = r(num_classes, c), r(num_classes)
    return sd


def test_swin_inflation_matches_vitta_tpus():
    depths, heads = (2, 1), (2, 4)
    ref = _image_swin(16, depths, heads, window=3)
    want = swin_state_dict_from_jax(
        inflate_swin2d_checkpoint(ref, K, patch_t=2, window_t=2,
                                  depths=depths, window_hw=(3, 3)),
        depths=depths, window_size=(2, 3, 3))
    got = inflate_swin2d_state_dict(ref, K, patch_t=2, window_t=2,
                                    window_hw=(3, 3))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    Recognizer3D(K, window_size=(2, 3, 3), embed_dim=16, depths=depths,
                 num_heads=heads).load_state_dict(got, strict=True)


@pytest.mark.parametrize("module,dataset,classes", [
    ("tta_swin_kinetics", "kinetics", 400),
    ("tta_swin_ssv2", "somethingv2", 174)])
def test_kinetics_and_ssv2_drivers(module, dataset, classes, monkeypatch):
    """The drivers run tta_tanet_ucf101's sweep on Video Swin at the
    dataset's class count (vitta_tpu's scripts/tta_swin_{kinetics,ssv2}.py),
    later flags override theirs, and a stream-parallel sweep raises naming
    ROADMAP.md queue 1 item 13."""
    import importlib
    from vitta_tpu.cli.opts import get_opts as jax_get_opts
    from vitta_tpu_torch.scripts import tta_tanet_ucf101
    driver = importlib.import_module(f"vitta_tpu_torch.scripts.{module}")
    seen = []
    monkeypatch.setattr(tta_tanet_ucf101, "run_corruption_sweep",
                        lambda cfg, corruptions, source_kind: seen.append(
                            (cfg, corruptions)) or {"mean": [0.0]})
    driver.main(["--corruptions", "gauss"])
    driver.main(["--arch", "videomae"])
    (cfg, corruptions), (vit, _c) = seen
    _a, jcfg = jax_get_opts(["--arch", "videoswintransformer", "--dataset",
                             dataset])
    assert cfg.model.arch == "videoswintransformer"
    assert corruptions == ["gauss"]
    assert (cfg.data.dataset, cfg.model.num_classes) == (dataset, classes)
    assert cfg.model.num_classes == jcfg.model.num_classes
    assert cfg.tta.chosen_blocks == jcfg.tta.chosen_blocks
    assert (vit.model.arch, vit.model.num_classes) == ("videomae", classes)
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        driver.main(["--n_parallel_streams", "2", "--corruptions", "gauss"])
