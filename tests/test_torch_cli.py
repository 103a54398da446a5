"""The port's CLI (vitta_tpu_torch/cli: opts, main_eval, drivers, and the
entry scripts) against vitta_tpu's on the CPU.

One reference-format checkpoint (a torch TSN's state dict under
``state_dict`` with DataParallel's ``module.`` prefix, as the reference's
``tanet_ucf.pth.tar``) is written once; both packages' ``evaluate`` read it
through ``--model_path`` with SKILL.md's tiny flags (T = 2, 32 x 32 crops
of 40, synthetic videos from a list file) and run the BNS stream and every
baseline; the top-1 of each must be equal.  The list's labels are the
source model's own predictions on all but one video, so that top-1 is not
0 by construction.  Then the flags parse to vitta_tpu's configuration, the
precompute writes vitta_tpu's statistics files (at
tests/test_torch_precompute.py's rtol 1e-3 / atol 1e-5), and the port's run
device, the model zoo's checkpoint paths and sweep modes raise where they
should.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.cli import main_eval as jax_main_eval
from vitta_tpu.cli.opts import get_opts as jax_get_opts
from vitta_tpu.data.records import parse_list_file as jax_parse_list_file
from vitta_tpu_torch.baselines import setup_baseline
from vitta_tpu_torch.cli import drivers, main_eval
from vitta_tpu_torch.cli.opts import get_opts, run_device
from vitta_tpu_torch.data.records import parse_list_file
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import load_reference_stats

torch.set_num_threads(1)

T, CLASSES, N_VIDEOS = 2, 101, 3
TINY = ["--clip_length", str(T), "--input_size", "32", "--scale_size", "40",
        "--video_source", "synthetic", "--workers", "1"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(checkpoint path, list file path) of the tiny runs."""
    root = tmp_path_factory.mktemp("cli")
    torch.manual_seed(0)
    oracle = TorchTSN(CLASSES, T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    ckpt = root / "tanet_tiny.pth.tar"
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in
                                           oracle.state_dict().items()}},
               ckpt)
    listing = root / "list.txt"
    listing.write_text("".join(f"vid_{i} {44 + 4 * i} 0\n"
                               for i in range(N_VIDEOS)))
    # labels: the source model's predictions, the last video's moved by one
    _args, cfg = get_opts(TINY + ["--model_path", str(ckpt), "--val_vid_list",
                                  str(listing), "--result_dir",
                                  str(root / "probe")])
    preds = []
    b = setup_baseline("source", get_model(cfg), cfg,
                       main_eval.load_variables(cfg), device="cpu")
    for sample in main_eval.make_datasets(cfg, "synthetic",
                                          emit_uint8=False).eval:
        with torch.no_grad():
            logits = b.model(torch.from_numpy(sample.frames), None)
        preds.append(int(logits.mean(0).argmax()))
    preds[-1] = (preds[-1] + 1) % CLASSES
    listing.write_text("".join(f"vid_{i} {44 + 4 * i} {p}\n"
                               for i, p in enumerate(preds)))
    return ckpt, listing, root


def both_cfgs(files, extra, monkeypatch):
    ckpt, listing, root = files
    argv = TINY + ["--model_path", str(ckpt), "--val_vid_list", str(listing),
                   *extra]
    monkeypatch.setenv("VITTA_PLATFORM", "cpu")
    _a, jcfg = jax_get_opts(argv + ["--result_dir", str(root / "jax")])
    _a, cfg = get_opts(argv + ["--result_dir", str(root / "port")])
    return jcfg, cfg


@pytest.mark.parametrize("baseline",
                         ["source", "norm", "tent", "shot", "dua", "t3a"])
def test_baseline_top1_matches_vitta_tpu(files, baseline, monkeypatch):
    jcfg, cfg = both_cfgs(files, ["--tta", "false", "--baseline", baseline,
                                  "--batch_size", "2", "--t3a_filter_k", "3"],
                          monkeypatch)
    want, _ = jax_main_eval.evaluate(jcfg, "gauss", source_kind="synthetic")
    got, state = main_eval.evaluate(cfg, "gauss", source_kind="synthetic")
    assert state is None
    assert got == want
    if baseline == "source":
        assert got == [100.0 * (N_VIDEOS - 1) / N_VIDEOS]


def test_bns_stream_top1_matches_vitta_tpu(files, monkeypatch):
    jcfg, cfg = both_cfgs(files, ["--stat_reg", "BNS"], monkeypatch)
    want, _ = jax_main_eval.evaluate(jcfg, "gauss", source_kind="synthetic")
    got, state = main_eval.evaluate(cfg, "gauss", source_kind="synthetic")
    assert got == want and state.step == N_VIDEOS


def test_entry_script_runs_a_sweep(files, monkeypatch):
    from vitta_tpu_torch.scripts import sourceonly_ucf101_corr
    ckpt, listing, root = files
    monkeypatch.setenv("VITTA_PLATFORM", "cpu")
    results = sourceonly_ucf101_corr.main(
        TINY + ["--model_path", str(ckpt), "--val_vid_list", str(listing),
                "--tta", "false", "--corruptions", "gauss", "contrast",
                "--result_dir", str(root / "script")])
    assert set(results) == {"gauss", "contrast", "mean"}
    assert results["gauss"] == [100.0 * (N_VIDEOS - 1) / N_VIDEOS]
    assert (root / "script" / "sweep_state.json").exists()
    assert len(list((root / "script").glob("*_all_result"))) == 1


def test_compute_stats_matches_vitta_tpu(files, monkeypatch):
    jcfg, cfg = both_cfgs(files, ["--batch_size", "2"], monkeypatch)
    ckpt, listing, root = files
    want = jax_main_eval.run_compute_stats(
        jcfg, source_kind="synthetic",
        records=jax_parse_list_file(str(listing)),
        out_dir=str(root / "jstats"))
    got = main_eval.run_compute_stats(
        cfg, source_kind="synthetic", records=parse_list_file(str(listing)),
        out_dir=str(root / "stats"))
    w = load_reference_stats(want[0], want[1], "tanet")
    g = load_reference_stats(got[0], got[1], "tanet")
    assert g.keys() == w.keys() and len(g) == 53   # TANet's BatchNorm2d
    for name, (m, v) in w.items():
        # tests/test_torch_precompute.py's tolerance
        np.testing.assert_allclose(g[name][0], m, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(g[name][1], v, rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_flags_parse_to_vitta_tpus_configuration(monkeypatch):
    argv = ["--clip_length", "8", "--lambda_pred_consis", "0.05",
            "--chosen_blocks", "layer4", "--momentum_mvg", "0.2",
            "--stat_type", "temp", "spatial", "--fix_BNS", "false",
            "--update_only_bn_affine", "--resume", "--stream_ckpt_every", "7",
            "--baseline", "shot", "--compute_dtype", "bfloat16"]
    for arch in ("tanet", "videoswintransformer"):
        _a, jcfg = jax_get_opts(argv + ["--arch", arch])
        _a, cfg = get_opts(argv + ["--arch", arch])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.tta.chosen_blocks == ("layer4",) and cfg.runtime.resume


def test_what_the_port_does_not_run(monkeypatch):
    # the model zoo builds, but loads no checkpoint (as in vitta_tpu)
    _a, cfg = get_opts(["--arch", "i3d_resnet50", "--model_path", "x.pth"])
    with pytest.raises(NotImplementedError, match="checkpoints load"):
        main_eval.load_variables(cfg)
    monkeypatch.setenv("VITTA_PLATFORM", "cpu")
    assert run_device() == torch.device("cpu")
    monkeypatch.setenv("VITTA_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        run_device()
    if not torch.cuda.is_available():
        monkeypatch.delenv("VITTA_PLATFORM")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_device()
    _a, cfg = get_opts(["--n_parallel_streams", "4"])
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        drivers.run_corruption_sweep(cfg, ["gauss"])
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        drivers.run_parallel_sweep(cfg, ["gauss"])
    _a, cfg = get_opts(["--streams_per_chip", "4"])
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        drivers.run_corruption_sweep(cfg, ["gauss"])
    with pytest.raises(ValueError, match="stats_npz"):
        get_opts(["--stats_npz", "stats.npz"])
