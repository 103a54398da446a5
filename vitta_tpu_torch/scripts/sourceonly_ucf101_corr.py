"""Source-only (or any baseline) evaluation over the 12 corruptions — the
port's counterpart of scripts/sourceonly_ucf101_corr.py (reference
sourceonly_{tanet,swin}_ucf101_corr.py: tta=False, baseline='source',
batch 32, uniform-1, 1 crop):

  python -m vitta_tpu_torch.scripts.sourceonly_ucf101_corr --arch tanet \\
      --tta false --batch_size 32 --baseline source --model_path ... \\
      --video_data_dir ... --val_vid_list '.../{}.txt'

``--baseline`` is one of source, norm, tent, shot, dua, t3a (shot and t3a
on TANet only).
"""

from vitta_tpu_torch.cli.drivers import run_corruption_sweep
from vitta_tpu_torch.cli.opts import get_opts
from vitta_tpu_torch.config import CORRUPTIONS


def main(argv=None):
    args, cfg = get_opts(argv)
    corruptions = list(CORRUPTIONS)
    if args.corruptions:
        corruptions = list(args.corruptions)
    results = run_corruption_sweep(cfg, corruptions,
                                   source_kind=args.video_source)
    print({k: [round(float(x), 3) for x in v] for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
