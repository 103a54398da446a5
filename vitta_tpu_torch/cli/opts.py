"""Command-line flag system -> typed VittaConfig.

The PyTorch counterpart of vitta_tpu/cli/opts.py: the same flags and
``config_from_args``.  Mirrors the reference's global argparse parser
(utils/opts.py:11-132) flag-for-flag where meaningful, but parses into the
frozen dataclass config instead of a mutable namespace, and uses real
booleans (the reference's ``type=bool`` flags treat any string as True).

The device takes the place of vitta_tpu's platform override:
``VITTA_PLATFORM=cpu`` runs on the CPU, anything else unset runs on the
card and raises where there is none (``run_device``).  vitta_tpu's
persistent compilation cache has no counterpart (the port compiles its
kernels with nvcc into build/ once).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from vitta_tpu_torch.config import (VittaConfig, num_classes_for,
                                    swin_ucf101_preset, tanet_ucf101_preset)


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="vitta_tpu_torch")
    # data (opts.py:15-39)
    p.add_argument("--dataset", default="ucf101",
                   choices=["ucf101", "somethingv2", "kinetics"])
    p.add_argument("--video_data_dir", default="")
    p.add_argument("--vid_format", default="")
    p.add_argument("--val_vid_list", default="")
    # 'video' = container decode, preferring the first-party native
    # FFmpeg decoder (csrc/vitta_decode.cpp) and falling back to decord —
    # the reference's datatype 'video' default (utils/opts.py:23)
    p.add_argument("--video_source", default="video",
                   choices=["video", "ffmpeg", "decord", "npy", "frames",
                            "synthetic"])
    p.add_argument("--result_dir", default="results")
    p.add_argument("--spatiotemp_mean_clean_file", default="")
    p.add_argument("--spatiotemp_var_clean_file", default="")
    p.add_argument("--temp_mean_clean_file", default="")
    p.add_argument("--temp_var_clean_file", default="")
    p.add_argument("--spatial_mean_clean_file", default="")
    p.add_argument("--spatial_var_clean_file", default="")
    p.add_argument("--temp_cossim_clean_file", default="")
    p.add_argument("--stats_npz", default="",
                   help="parsed as in vitta_tpu, which reads it nowhere; "
                        "setting it raises (pass the .npy files above)")
    # model (opts.py:43-58)
    p.add_argument("--arch", default="tanet",
                   choices=["tanet", "videoswintransformer", "i3d_resnet18",
                            "i3d_resnet50", "i3d_incep", "r2plus1d",
                            "videomae"])
    p.add_argument("--model_path", default="")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of TANet (params, statistics and "
                        "the classifier stay float32); every other model is "
                        "built at float32 under either")
    p.add_argument("--partial_bn", action="store_true")
    p.add_argument("--num_clips", type=int, default=1)
    p.add_argument("--frame_uniform", type=str2bool, default=True)
    p.add_argument("--frame_interval", type=int, default=2)
    p.add_argument("--flip_ratio", type=float, default=0)
    # runtime (opts.py:62-68)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--verbose", type=str2bool, default=True)
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--n_parallel_streams", type=int, default=1,
                   help="corruption streams adapted at once, one process a "
                        "stream under torchrun (cli/drivers.py:"
                        "run_parallel_sweep)")
    p.add_argument("--streams_per_chip", type=int, default=1,
                   help="stream processes that share one card in a "
                        "stream-parallel sweep")
    p.add_argument("--resume", action="store_true",
                   help="skip corruptions already completed per "
                        "<result_dir>/sweep_state.json")
    p.add_argument("--stream_ckpt_every", type=int, default=0,
                   help="checkpoint the TTA state every N videos so "
                        "--resume recovers mid-corruption (0 = off)")
    p.add_argument("--corruptions", nargs="+", default=None,
                   help="subset of corruption names for the sweep drivers "
                        "(default: all 12, reference tta_tanet_ucf101.py:9-11)")
    # learning / TTA (opts.py:72-121)
    p.add_argument("--tta", type=str2bool, default=True)
    p.add_argument("--baseline", default="source",
                   choices=["source", "norm", "tent", "shot", "dua", "t3a"])
    p.add_argument("--t3a_filter_k", type=int, default=100,
                   help="support-set size per class for T3A (undeclared in "
                        "the reference parser, injected manually there; "
                        "t3a.py:52)")
    p.add_argument("--compute_stat", default="",
                   choices=["", "mean_var", "cossim"])
    p.add_argument("--stat_type", nargs="+", default=["spatiotemp"],
                   help="statistic type(s); the live regularization takes "
                        "exactly one (reference norm_stats_utils.py:131)")
    p.add_argument("--use_src_stat_in_reg", type=str2bool, default=True)
    p.add_argument("--fix_BNS", type=str2bool, default=True)
    p.add_argument("--running_manner", type=str2bool, default=True)
    p.add_argument("--momentum_bns", type=float, default=0.1)
    p.add_argument("--update_only_bn_affine", action="store_true")
    p.add_argument("--momentum_mvg", type=float, default=0.1)
    p.add_argument("--stat_reg", default="mean_var")
    p.add_argument("--if_tta_standard", default="tta_online")
    p.add_argument("--if_sample_tta_aug_views", type=str2bool, default=True)
    p.add_argument("--if_spatial_rand_cropping", type=str2bool, default=True)
    p.add_argument("--if_pred_consistency", type=str2bool, default=True)
    p.add_argument("--lambda_pred_consis", type=float, default=0.1)
    p.add_argument("--lambda_feature_reg", type=float, default=1.0)
    p.add_argument("--n_augmented_views", type=int, default=2)
    p.add_argument("--tta_view_sample_style", default="uniform_equidist")
    p.add_argument("--before_norm", action="store_true")
    p.add_argument("--reg_type", default="l1_loss")
    p.add_argument("--chosen_blocks", nargs="+", default=None)
    p.add_argument("--moving_avg", type=str2bool, default=True)
    p.add_argument("--n_gradient_steps", type=int, default=1)
    p.add_argument("--full_res", action="store_true")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--scale_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--clip_length", type=int, default=16)
    p.add_argument("--sample_style", default="uniform-1")
    p.add_argument("--test_crops", type=int, default=1)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=0)
    return p


def config_from_args(args: argparse.Namespace) -> VittaConfig:
    if args.stats_npz:
        raise ValueError(
            "--stats_npz: neither package reads a stats archive; pass the "
            "--*_clean_file .npy pairs")
    # the model zoo's other archs take the TANet preset, as
    # vitta_tpu/cli/opts.py:131-146 builds them
    base = (swin_ucf101_preset() if args.arch == "videoswintransformer"
            else tanet_ucf101_preset())
    data = dataclasses.replace(
        base.data, dataset=args.dataset, video_data_dir=args.video_data_dir,
        val_vid_list=args.val_vid_list, vid_format=args.vid_format,
        clip_length=args.clip_length, sample_style=args.sample_style,
        test_crops=args.test_crops, input_size=args.input_size,
        scale_size=args.scale_size, full_res=args.full_res,
        batch_size=args.batch_size, num_workers=args.workers,
        debug=args.debug, num_clips=args.num_clips,
        frame_uniform=args.frame_uniform, frame_interval=args.frame_interval,
        flip_ratio=args.flip_ratio)
    model = dataclasses.replace(
        base.model, arch=args.arch,
        num_classes=num_classes_for(args.dataset),
        checkpoint_path=args.model_path,
        partial_bn=args.partial_bn,
        compute_dtype=args.compute_dtype)
    optim = dataclasses.replace(
        base.optim, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay,
        update_only_bn_affine=args.update_only_bn_affine)
    tta = dataclasses.replace(
        base.tta, tta=args.tta, if_tta_standard=args.if_tta_standard,
        stat_reg=args.stat_reg, reg_type=args.reg_type,
        before_norm=args.before_norm, moving_avg=args.moving_avg,
        momentum_mvg=args.momentum_mvg,
        n_gradient_steps=args.n_gradient_steps, fix_BNS=args.fix_BNS,
        running_manner=args.running_manner, momentum_bns=args.momentum_bns,
        use_src_stat_in_reg=args.use_src_stat_in_reg,
        if_sample_tta_aug_views=args.if_sample_tta_aug_views,
        n_augmented_views=args.n_augmented_views,
        tta_view_sample_style=args.tta_view_sample_style,
        if_spatial_rand_cropping=args.if_spatial_rand_cropping,
        if_pred_consistency=args.if_pred_consistency,
        lambda_pred_consis=args.lambda_pred_consis,
        lambda_feature_reg=args.lambda_feature_reg,
        chosen_blocks=tuple(args.chosen_blocks) if args.chosen_blocks
        else base.tta.chosen_blocks,
        stat_type=tuple(args.stat_type),
        spatiotemp_mean_clean_file=args.spatiotemp_mean_clean_file,
        spatiotemp_var_clean_file=args.spatiotemp_var_clean_file,
        temp_mean_clean_file=args.temp_mean_clean_file,
        temp_var_clean_file=args.temp_var_clean_file,
        spatial_mean_clean_file=args.spatial_mean_clean_file,
        spatial_var_clean_file=args.spatial_var_clean_file,
        temp_cossim_clean_file=args.temp_cossim_clean_file)
    runtime = dataclasses.replace(
        base.runtime, result_dir=args.result_dir, baseline=args.baseline,
        t3a_filter_k=args.t3a_filter_k, verbose=args.verbose,
        print_freq=args.print_freq, seed=args.seed,
        n_parallel_streams=args.n_parallel_streams,
        streams_per_chip=args.streams_per_chip, resume=args.resume,
        stream_ckpt_every=args.stream_ckpt_every)
    return VittaConfig(data=data, model=model, optim=optim, tta=tta,
                       runtime=runtime)


def run_device() -> torch.device:
    """The device a CLI run uses: the CPU where ``VITTA_PLATFORM=cpu``,
    otherwise the card; raises where there is none (no CPU fallback)."""
    plat = os.environ.get("VITTA_PLATFORM", "")
    if plat not in ("", "cpu", "cuda", "gpu"):
        raise ValueError(f"VITTA_PLATFORM={plat!r}: the port runs on "
                         "'cpu' or the card ('cuda')")
    if plat == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set "
                           "VITTA_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda")


def get_opts(argv=None):
    args = build_parser().parse_args(argv)
    return args, config_from_args(args)
