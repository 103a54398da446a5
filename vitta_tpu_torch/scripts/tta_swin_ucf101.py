"""ViTTA on Video Swin-B / UCF101-C — the port's counterpart of
scripts/tta_swin_ucf101.py (reference tta_swin_ucf101.py: clip 16, 1 clip,
frame_uniform, scale 224, lr 1e-5, lambda_pred_consis 0.05, momentum_mvg
0.05, chosen blocks backbone.layers.2/3 + backbone.norm — all defaults of
the swin preset).  Takes the flags of tta_tanet_ucf101 with
``--arch videoswintransformer`` set:

  python -m vitta_tpu_torch.scripts.tta_swin_ucf101 --model_path ... \\
      --video_data_dir ... --val_vid_list '.../{}.txt' \\
      --spatiotemp_mean_clean_file ... --spatiotemp_var_clean_file ...
"""

import sys

from vitta_tpu_torch.scripts import tta_tanet_ucf101


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return tta_tanet_ucf101.main(["--arch", "videoswintransformer", *argv])


if __name__ == "__main__":
    main()
