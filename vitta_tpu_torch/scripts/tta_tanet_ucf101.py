"""ViTTA on TANet / UCF101-C level 5 — the 12 shuffled corruption streams.

The port's counterpart of scripts/tta_tanet_ucf101.py (reference
tta_tanet_ucf101.py).  All reference defaults apply (utils/opts.py); on the
card:

  python -m vitta_tpu_torch.scripts.tta_tanet_ucf101 \\
      --model_path /path/tanet_ucf.pth.tar \\
      --video_data_dir /path/level_5_ucf_val_split_1 \\
      --val_vid_list '/path/list_video_perturbations/{}.txt' \\
      --spatiotemp_mean_clean_file /path/list_spatiotemp_mean_*.npy \\
      --spatiotemp_var_clean_file /path/list_spatiotemp_var_*.npy \\
      --result_dir results/tanet_ucf101 [--stream_ckpt_every 50 --resume]

With ``--n_parallel_streams N`` > 1 the streams are adapted N at a time,
one process a stream (``cli/drivers.py:run_parallel_sweep``), launched by
torchrun; ``--streams_per_chip N`` puts N of them on one card:

  torchrun --nproc_per_node 2 -m vitta_tpu_torch.scripts.tta_tanet_ucf101 \\
      --n_parallel_streams 2 --streams_per_chip 2 ...

``VITTA_PLATFORM=cpu`` runs it on the CPU.
"""

from vitta_tpu_torch.cli.drivers import run_corruption_sweep, run_parallel_sweep
from vitta_tpu_torch.cli.opts import get_opts
from vitta_tpu_torch.config import CORRUPTIONS


def main(argv=None):
    args, cfg = get_opts(argv)
    corruptions = [f"{c}_shuffled" for c in CORRUPTIONS]
    if args.corruptions:
        corruptions = list(args.corruptions)
    sweep = (run_parallel_sweep if cfg.runtime.n_parallel_streams > 1
             else run_corruption_sweep)
    results = sweep(cfg, corruptions, source_kind=args.video_source)
    print({k: [round(float(x), 3) for x in v] for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
