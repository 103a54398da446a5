"""Source-statistics precompute of the port against the JAX package's, on
the CPU, for TANet and Video Swin, and the statistics files both ways.

The same clips go through ``compute_source_statistics`` of both packages,
from shared weights.  Tolerance rtol 1e-3 / atol 1e-5 on every layer's
mean and variance: float32 convolutions and matrix products summed in
different orders (oneDNN against XLA:CPU), then averaged over the batches
in float64 on both sides.  Files are compared exactly: what one package
writes, the other reads back unchanged.  The relation-map precompute of the
cossim mode is held to the same tolerance (cosines of the same features),
and its file, with None at the layers that have no map, round-trips both
ways.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_swin import TorchRecognizer3D
from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt import precompute as jax_pre
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils import checkpoint as jax_ckpt
from vitta_tpu_torch.adapt import precompute as pre
from vitta_tpu_torch.config import swin_ucf101_preset, tanet_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

K = 5
SWIN_KW = dict(patch_size=(2, 4, 4), window_size=(2, 3, 3), embed_dim=8,
               depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8))
DEPTHS = SWIN_KW["depths"]


def _batches(t, hw, sizes=(2, 1, 2), seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, t, hw, hw, 3)).astype(np.float32),
             np.zeros(b, np.int64)) for b in sizes]


@pytest.fixture(scope="module")
def tanet():
    t, hw = 2, 32
    torch.manual_seed(0)
    oracle = TorchTSN(K, t)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    cfg = tanet_ucf101_preset()
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t),
        model=dataclasses.replace(cfg.model, num_classes=K),
        tta=dataclasses.replace(cfg.tta, stat_type=("spatiotemp", "temp")))
    model = get_model(cfg)
    model.load_state_dict(oracle.state_dict(), strict=True)
    jm = JaxTANet(num_classes=K, clip_length=t,
                  stat_types=("spatiotemp", "temp"))
    variables = jax_ckpt.convert_tanet_checkpoint(oracle.state_dict(), K)
    return model, jm, variables, _batches(t, hw)


@pytest.fixture(scope="module")
def swin():
    torch.manual_seed(1)
    oracle = TorchRecognizer3D(K, **SWIN_KW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    cfg = swin_ucf101_preset()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, num_classes=K, drop_path_rate=0.0, **SWIN_KW))
    model = get_model(cfg)
    model.load_state_dict(oracle.state_dict(), strict=True)
    jm = JaxRecognizer3D(num_classes=K, drop_path_rate=0.0, **SWIN_KW)
    variables = jax_ckpt.convert_swin_checkpoint(
        oracle.state_dict(), K, depths=DEPTHS,
        window_size=SWIN_KW["window_size"])
    return model, jm, variables, _batches(4, 24)


def _assert_stats_close(got, want):
    assert set(got) == set(want) and got
    for name, (m, v) in got.items():
        assert m.dtype == np.float32 and v.dtype == np.float32
        np.testing.assert_allclose(m, want[name][0], rtol=1e-3, atol=1e-5,
                                   err_msg=f"mean {name}")
        np.testing.assert_allclose(v, want[name][1], rtol=1e-3, atol=1e-5,
                                   err_msg=f"var {name}")


def _assert_stats_equal(got, want):
    assert set(got) == set(want) and got
    for name, (m, v) in got.items():
        np.testing.assert_array_equal(m, want[name][0], err_msg=name)
        np.testing.assert_array_equal(v, want[name][1], err_msg=name)


@pytest.mark.parametrize("stat_type", ["spatiotemp", "temp"])
def test_tanet_statistics_match_jax(tanet, stat_type):
    model, jm, variables, batches = tanet
    want = jax_pre.compute_source_statistics(jm, variables, batches,
                                             stat_type=stat_type)
    got = pre.compute_source_statistics(model, batches, device="cpu",
                                        stat_type=stat_type)
    _assert_stats_close(got, want)
    assert set(got) == {n for n, _ in ckpt.tanet_norm_layers()}


def test_swin_statistics_match_jax(swin):
    model, jm, variables, batches = swin
    want = jax_pre.compute_source_statistics(jm, variables, batches)
    got = pre.compute_source_statistics(model, batches, device="cpu")
    _assert_stats_close(got, want)
    assert set(got) == {n for n, _ in ckpt.swin_norm_layers(DEPTHS)}


def test_tap_filter_and_batch_weighting(swin):
    model, _jm, _variables, batches = swin
    only = pre.compute_source_statistics(
        model, batches, device="cpu", tap_filter=lambda n: "norm2" in n)
    assert only and all("norm2" in n for n in only)
    # the mean over batches is weighted by batch size (AverageMeter n=batch)
    name = sorted(only)[0]
    per = [pre.compute_source_statistics(model, [b], device="cpu")[name][0]
           for b in batches]
    sizes = np.asarray([b[0].shape[0] for b in batches], np.float64)
    want = sum(p.astype(np.float64) * n for p, n in zip(per, sizes)) / sizes.sum()
    np.testing.assert_allclose(only[name][0], want, rtol=1e-6, atol=1e-7)


def test_precompute_raises_without_a_card(swin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default would run on it")
    model, _jm, _variables, batches = swin
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pre.compute_source_statistics(model, batches)


def test_norm_layer_lists_match_jax():
    assert ckpt.tanet_norm_layers() == jax_ckpt.tanet_norm_layers()
    assert ckpt.tanet_norm_layers(False) == jax_ckpt.tanet_norm_layers(False)


@pytest.mark.parametrize("stat_type", ["spatiotemp", "temp"])
def test_tanet_files_round_trip_between_packages(tanet, tmp_path, stat_type):
    model, _jm, _variables, batches = tanet
    stats = pre.compute_source_statistics(model, batches[:1], device="cpu",
                                          stat_type=stat_type)
    bn1d = stat_type == "temp"
    kept = {n: s for n, s in stats.items()
            if bn1d or ("g_bn" not in n and "l_bn" not in n)}
    # the port writes, the JAX package reads
    mean_p, var_p, npz_p = pre.save_source_statistics(
        stats, "tanet", str(tmp_path / "port"), tag="t", stat_type=stat_type)
    _assert_stats_equal(jax_ckpt.load_reference_stats(
        mean_p, var_p, "tanet", include_bn1d=bn1d), kept)
    _assert_stats_equal(jax_pre.load_source_statistics_npz(npz_p), stats)
    # the JAX package writes, the port reads
    mean_j, var_j, npz_j = jax_pre.save_source_statistics(
        stats, "tanet", str(tmp_path / "jax"), tag="t", stat_type=stat_type)
    _assert_stats_equal(ckpt.load_reference_stats(
        mean_j, var_j, "tanet", include_bn1d=bn1d), kept)
    _assert_stats_equal(pre.load_source_statistics_npz(npz_j), stats)


def test_swin_files_round_trip_between_packages(swin, tmp_path):
    model, _jm, _variables, batches = swin
    stats = pre.compute_source_statistics(model, batches[:1], device="cpu")
    mean_p, var_p, npz_p = pre.save_source_statistics(
        stats, "videoswintransformer", str(tmp_path / "port"), tag="t",
        depths=DEPTHS)
    # the JAX package's writer takes the depths, its reader is fixed to
    # Swin-B's: at this depth compare what the two writers put on disk,
    # entry by entry, and read both with the port
    jmean, jvar = str(tmp_path / "jm.npy"), str(tmp_path / "jv.npy")
    jax_ckpt.save_stats(jmean, jvar, stats, "videoswintransformer",
                        depths=DEPTHS)
    for ours, theirs in ((mean_p, jmean), (var_p, jvar)):
        a = list(np.load(ours, allow_pickle=True))
        b = list(np.load(theirs, allow_pickle=True))
        assert len(a) == len(b) == len(ckpt.swin_norm_layers(DEPTHS))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _assert_stats_equal(ckpt.load_reference_stats(
        jmean, jvar, "videoswintransformer", depths=DEPTHS), stats)
    _assert_stats_equal(ckpt.load_reference_stats(
        mean_p, var_p, "videoswintransformer", depths=DEPTHS), stats)
    _assert_stats_equal(jax_pre.load_source_statistics_npz(npz_p), stats)
    with pytest.raises(ValueError):
        ckpt.load_reference_stats(mean_p, var_p, "videoswintransformer")


def test_swin_b_file_pair_loads_in_the_jax_package(tmp_path):
    """At Swin-B's own depths the pair the port writes loads in the JAX
    package's reader (52 entries in ``swin_norm_layers`` order)."""
    rng = np.random.default_rng(0)
    stats = {n: (rng.normal(size=4).astype(np.float32),
                 rng.random(4).astype(np.float32))
             for n, _ in ckpt.swin_norm_layers()}
    mean_p, var_p, _ = pre.save_source_statistics(
        stats, "videoswintransformer", str(tmp_path), tag="b")
    _assert_stats_equal(jax_ckpt.load_reference_stats(
        mean_p, var_p, "videoswintransformer"), stats)


@pytest.mark.parametrize("stat_type", ["temp", "spatiotemp"])
def test_tanet_cossim_statistics_match_jax(tanet, stat_type):
    model, jm, variables, batches = tanet
    want = jax_pre.compute_cossim_statistics(jm, variables, batches,
                                             clip_len=2, stat_type=stat_type)
    got = pre.compute_cossim_statistics(model, batches, clip_len=2,
                                        stat_type=stat_type, device="cpu")
    assert set(got) == set(want) and got
    # every BatchNorm2d, and for 'temp' the rank-3 l_bn of each TAM too
    assert len(got) == (53 + 16 if stat_type == "temp" else 53)
    for name, vec in got.items():
        assert vec.dtype == np.float32 and vec.shape == want[name].shape
        np.testing.assert_allclose(vec, want[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_swin_cossim_statistics_match_jax(swin):
    model, _jm, variables, batches = swin
    # built as a cossim run builds it (``tap_stat_types``): with the
    # spatiotemp taps alone the JAX stages keep their activations in window
    # layout, which has no time axis to relate
    jm = JaxRecognizer3D(num_classes=K, drop_path_rate=0.0,
                         stat_types=("cossim",), **SWIN_KW)
    want = jax_pre.compute_cossim_statistics(jm, variables, batches,
                                             clip_len=4)
    keep = lambda n: "patch_embed" not in n
    got = pre.compute_cossim_statistics(model, batches, clip_len=4,
                                        device="cpu", tap_filter=keep)
    assert set(got) == {n for n in want if keep(n)}
    assert set(got) == {n for n, _ in ckpt.swin_norm_layers(DEPTHS)}
    for name, vec in got.items():
        np.testing.assert_allclose(vec, want[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_cossim_precompute_leaves_no_hook_and_refuses_window_layout(swin):
    model, _jm, _variables, batches = swin
    pre.compute_cossim_statistics(model, batches[:1], clip_len=4,
                                  device="cpu")
    assert not any(m._forward_hooks for m in model.modules())
    cfg = swin_ucf101_preset()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, num_classes=K, drop_path_rate=0.0, **SWIN_KW))
    with pytest.raises(ValueError, match="ln_proj"):
        pre.compute_cossim_statistics(get_model(cfg, attn_route="ln_proj"),
                                      batches[:1], clip_len=4, device="cpu")


def test_cossim_files_round_trip_between_packages(tanet, tmp_path):
    model, _jm, _variables, batches = tanet
    sims = pre.compute_cossim_statistics(model, batches[:1], clip_len=2,
                                         device="cpu")
    names = [n for n, _ in ckpt.tanet_norm_layers()]
    assert any(n not in sims for n in names)        # the g_bn placeholders

    def check(loaded):
        assert list(loaded) == names
        for n in names:
            if n in sims:
                np.testing.assert_array_equal(loaded[n], sims[n], err_msg=n)
            else:
                assert loaded[n] is None

    port_file, jax_file = str(tmp_path / "p.npy"), str(tmp_path / "j.npy")
    ckpt.save_cossim(port_file, sims, "tanet")
    jax_ckpt.save_cossim(jax_file, sims, "tanet")
    for path in (port_file, jax_file):
        check(jax_ckpt.load_reference_cossim(path, "tanet"))
        check(ckpt.load_reference_cossim(path, "tanet"))
    with pytest.raises(ValueError):
        ckpt.load_reference_cossim(port_file, "videoswintransformer")


def test_swin_cossim_file_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    sims = {n: rng.normal(size=6).astype(np.float32)
            for n, _ in ckpt.swin_norm_layers(DEPTHS)}
    path = str(tmp_path / "s.npy")
    ckpt.save_cossim(path, sims, "videoswintransformer", depths=DEPTHS)
    for loaded in (ckpt.load_reference_cossim(path, "videoswintransformer",
                                              depths=DEPTHS),
                   jax_ckpt.load_reference_cossim(
                       path, "videoswintransformer", depths=DEPTHS)):
        assert set(loaded) == set(sims)
        for n, v in sims.items():
            np.testing.assert_array_equal(loaded[n], v)
