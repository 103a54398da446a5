"""Source statistics precompute over the clean training list — the port's
counterpart of scripts/compute_stats.py (reference
compute_stats/compute_spatiotemp_stats_clean_train_{tanet,swin}.py: batch
32, the deterministic eval pipeline, clean data):

  python -m vitta_tpu_torch.scripts.compute_stats --arch tanet \\
      --batch_size 32 --model_path ... --video_data_dir ... \\
      --val_vid_list train_list.txt --result_dir stats_out \\
      [--compute_stat cossim --stat_type temp]
"""

from vitta_tpu_torch.cli.main_eval import run_compute_stats
from vitta_tpu_torch.cli.opts import get_opts


def main(argv=None):
    args, cfg = get_opts(argv)
    paths = run_compute_stats(cfg, source_kind=args.video_source,
                              compute_stat=args.compute_stat or "mean_var")
    print(paths)
    return paths


if __name__ == "__main__":
    main()
