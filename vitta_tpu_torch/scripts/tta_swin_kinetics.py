"""ViTTA on Video Swin-B / Kinetics-400-C (400 classes) — the port's
counterpart of scripts/tta_swin_kinetics.py: the tta_swin_ucf101 driver
with ``--dataset kinetics`` (the per-arch Swin settings of
tta_swin_ucf101.py and 400 classes, as ``config.kinetics_preset``).  Takes
the flags of tta_tanet_ucf101; flags given after these override them
(``--arch videomae`` runs the model zoo's ViT on the same protocol):

  python -m vitta_tpu_torch.scripts.tta_swin_kinetics --model_path ... \\
      --video_data_dir ... --val_vid_list '.../{}.txt' \\
      --spatiotemp_mean_clean_file ... --spatiotemp_var_clean_file ...

``--n_parallel_streams`` > 1 adapts the streams that many at a time, one
process a stream under torchrun, as tta_tanet_ucf101 says.
"""

import sys

from vitta_tpu_torch.scripts import tta_tanet_ucf101


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return tta_tanet_ucf101.main(["--arch", "videoswintransformer",
                                  "--dataset", "kinetics", *argv])


if __name__ == "__main__":
    main()
