"""Typed configuration for vitta_tpu_torch.

A copy of vitta_tpu/config.py without ``label_flip_map``, which reaches
into the data layer: the port imports nothing of the JAX package.

Replaces the reference's single global argparse parser with imperative
per-script overrides (reference utils/opts.py:11-132 and the "To Specify"
blocks in e.g. tta_tanet_ucf101.py:19-26) with frozen dataclasses and
per-architecture presets.  Field defaults mirror the reference defaults
line-for-line where they matter for parity (cited below).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Normalization constants (reference utils/opts.py:3-9).
TANET_INPUT_MEAN = (0.485, 0.456, 0.406)
TANET_INPUT_STD = (0.229, 0.224, 0.225)
# Video Swin operates on 0-255 pixel scale (mmcv-style normalize).
SWIN_IMG_NORM_MEAN = (123.675, 116.28, 103.53)
SWIN_IMG_NORM_STD = (58.395, 57.12, 57.375)

# The 12 corruption types of the UCF101-C / K400-C / SSv2-C benchmark,
# shuffled-stream variants (reference tta_tanet_ucf101.py:9-11).
CORRUPTIONS = (
    "gauss", "pepper", "salt", "shot", "zoom", "impulse",
    "defocus", "motion", "jpeg", "contrast", "rain", "h265_abr",
)


@dataclass(frozen=True)
class DataConfig:
    """Video data pipeline configuration.

    Mirrors reference utils/opts.py:15-39 (paths) and 105-112 (shapes).
    """

    dataset: str = "ucf101"            # ucf101 | somethingv2 | kinetics
    video_data_dir: str = ""
    val_vid_list: str = ""             # list file: "<path> <n_frames> <label>"
    vid_format: str = ""
    clip_length: int = 16              # T (opts.py:109)
    sample_style: str = "uniform-1"    # 'uniform-N' | 'dense-N' (opts.py:110)
    test_crops: int = 1                # spatial crops (opts.py:112)
    input_size: int = 224              # network input (opts.py:106)
    scale_size: int = 256              # shorter-side resize (opts.py:107)
    full_res: bool = False             # feed scale_size^2 instead (opts.py:105)
    batch_size: int = 1                # videos per step (opts.py:108)
    num_workers: int = 8               # host decode workers (opts.py:63)
    debug: bool = False                # first 50 videos only (opts.py:66)
    debug_vid: int = 50
    # Swin-only pipeline knobs (opts.py:51-54).
    num_clips: int = 1
    frame_uniform: bool = True
    frame_interval: int = 2
    flip_ratio: float = 0.0
    input_mean: Tuple[float, ...] = TANET_INPUT_MEAN
    input_std: Tuple[float, ...] = TANET_INPUT_STD
    # Deprecated I3D-era loader path (the reference get_dataset 'vid'
    # branch, basics.py:1350-1444; tsn_style is its undeclared flag).
    legacy_loader: bool = False
    tsn_style: bool = True

    @property
    def network_input_size(self) -> int:
        return self.scale_size if self.full_res else self.input_size


@dataclass(frozen=True)
class ModelConfig:
    """Model-zoo configuration (reference utils/opts.py:43-58)."""

    arch: str = "tanet"                # tanet | videoswintransformer | ...
    num_classes: int = 101
    checkpoint_path: str = ""
    # TANet / TSN
    dropout: float = 0.8               # TSN dropout before new_fc
    # partial-BN (freeze BN2d affine except the first, tanet.py:182-198) is
    # OFF in the live runs: --partial_bn is store_true (opts.py:48, default
    # False) and passed through at basics.py:1474.
    partial_bn: bool = False
    consensus_type: str = "avg"
    # Video Swin-B (fixed config, reference recognizer3d.py:45-90)
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    drop_path_rate: float = 0.2
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"     # bfloat16 for speed runs


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer for the adaptation step (reference utils/opts.py:118-121,
    corpus/basics.py:547-560)."""

    lr: float = 5e-5
    momentum: float = 0.9              # SGD momentum
    weight_decay: float = 5e-4
    update_only_bn_affine: bool = False  # Adam on norm gamma/beta instead
    adam_b1: float = 0.9
    adam_b2: float = 0.999


@dataclass(frozen=True)
class TTAConfig:
    """ViTTA adaptation configuration (reference utils/opts.py:72-99)."""

    tta: bool = True
    if_tta_standard: str = "tta_online"    # 'tta_online' | 'tta_standard'
    stat_reg: str = "mean_var"             # 'mean_var' | 'BNS' | 'cossim'
    stat_type: Tuple[str, ...] = ("spatiotemp",)
    reg_type: str = "l1_loss"              # 'l1_loss' | 'mse_loss' | 'kld'
    before_norm: bool = False              # stats on norm input instead of output
    moving_avg: bool = True
    momentum_mvg: float = 0.1              # EMA momentum (1.0 for tta_standard)
    n_gradient_steps: int = 1
    n_epoch_adapat: int = 1
    fix_BNS: bool = True                   # norm layers always in inference form
    running_manner: bool = True            # (BNS baseline reg)
    momentum_bns: float = 0.1
    use_src_stat_in_reg: bool = True
    # multi-view augmentation
    if_sample_tta_aug_views: bool = True
    n_augmented_views: int = 2
    tta_view_sample_style: str = "uniform_equidist"
    if_spatial_rand_cropping: bool = True
    if_pred_consistency: bool = True
    lambda_pred_consis: float = 0.1
    lambda_feature_reg: float = 1.0
    # which norm layers participate in the stat regularization: a layer
    # is chosen when any of these substrings occurs in its path name
    # (reference corpus/basics.py:571-587)
    chosen_blocks: Tuple[str, ...] = ("layer3", "layer4")
    # precomputed source statistics, one file pair per statistic type
    # (reference utils/opts.py: spatiotemp/temp/spatial *_clean_file flags;
    # the temporal pair also serves temp_v2, basics.py:751-752)
    spatiotemp_mean_clean_file: str = ""
    spatiotemp_var_clean_file: str = ""
    temp_mean_clean_file: str = ""
    temp_var_clean_file: str = ""
    spatial_mean_clean_file: str = ""
    spatial_var_clean_file: str = ""
    temp_cossim_clean_file: str = ""

    def validate(self) -> None:
        # Mode invariants, reference corpus/basics.py:414-423.
        if self.if_tta_standard == "tta_standard":
            assert self.momentum_mvg == 1.0
            assert self.n_epoch_adapat == 1
        elif self.if_tta_standard == "tta_online":
            assert self.momentum_mvg != 1.0
            assert self.n_gradient_steps == 1
            assert self.n_epoch_adapat == 1
        else:
            raise ValueError(f"unknown if_tta_standard={self.if_tta_standard}")
        # Regularization-mode invariants: the reference raises on unknown
        # stat_reg (basics.py:936-937); stat_type entries feed the tap
        # engine (norm_stats_utils.py:80-98 + relation_map_utils.py).
        if self.stat_reg not in ("mean_var", "BNS", "cossim"):
            raise ValueError(
                f"unknown stat_reg={self.stat_reg!r} "
                "(expected 'mean_var', 'BNS' or 'cossim')")
        if not self.stat_type:
            raise ValueError("stat_type must name at least one statistic type")
        known = ("spatiotemp", "spatial", "temp", "temp_v2")
        for st in self.stat_type:
            if st not in known:
                raise ValueError(f"unknown stat_type entry {st!r} "
                                 f"(expected one of {known})")
        if self.stat_reg == "cossim":
            # CombineCossimRegHook only implements the temporal relation
            # map ('temp' branches, relation_map_utils.py:254-321); any
            # other stat_type silently yields a zero regularizer in the
            # reference — rejected loudly here.
            if "temp" not in self.stat_type:
                raise ValueError(
                    "stat_reg='cossim' requires 'temp' in stat_type (the "
                    "reference hook only regularizes the temporal relation "
                    "map, relation_map_utils.py:254-321; with other types "
                    "its loss is identically zero)")
            if self.reg_type == "kld":
                raise ValueError("stat_reg='cossim' supports l1_loss/mse_loss "
                                 "only (relation_map_utils.py:326-331)")

    def tap_stat_types(self) -> Tuple[str, ...]:
        """Statistic-tap leaves the model must sow for this config:
        the configured ``stat_type`` list, or the pairwise-similarity
        tap when the cossim regularization is active."""
        if self.stat_reg == "cossim":
            return ("cossim",)
        return tuple(self.stat_type)


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution-environment knobs (replaces opts.py:62-68)."""

    result_dir: str = "results"
    baseline: str = "source"   # active when tta=False (opts.py:129-131)
    t3a_filter_k: int = 100    # undeclared in the reference parser (t3a.py:52)
    verbose: bool = True
    print_freq: int = 20
    seed: int = 0
    # parallelism: number of corruption streams adapted simultaneously,
    # sharded over the device mesh (the reference is single-GPU,
    # DataParallel-wrapped: corpus/main_eval.py:61-65).
    n_parallel_streams: int = 1
    # streams vmapped per chip within the shard_map blocks (>1 packs the
    # 12-corruption sweep onto fewer/fuller chips, e.g. 12 streams on 6
    # chips at 2/chip in ONE pass instead of an 8+4 split; gate on the
    # multistream_bench measurement for the model at hand)
    streams_per_chip: int = 1
    mesh_axis_name: str = "stream"
    profile_dir: str = ""
    # resume an interrupted corruption sweep: corruptions already
    # recorded in <result_dir>/sweep_state.json are skipped and their
    # rows replayed (operational addition; the reference restarts from
    # scratch)
    resume: bool = False
    # checkpoint the carried TTAState every N videos so --resume also
    # recovers MID-corruption (adapt/stream_ckpt.py); 0 = off
    stream_ckpt_every: int = 0


@dataclass(frozen=True)
class VittaConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    tta: TTAConfig = field(default_factory=TTAConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    corruptions: Tuple[str, ...] = tuple(f"{c}_shuffled" for c in CORRUPTIONS)

    def replace(self, **kw) -> "VittaConfig":
        return dataclasses.replace(self, **kw)


def tanet_ucf101_preset(**overrides) -> VittaConfig:
    """Preset matching reference tta_tanet_ucf101.py (all defaults)."""
    cfg = VittaConfig(
        data=DataConfig(dataset="ucf101"),
        model=ModelConfig(arch="tanet", num_classes=101),
        optim=OptimConfig(),
        tta=TTAConfig(chosen_blocks=("layer3", "layer4")),
    )
    return cfg.replace(**overrides) if overrides else cfg


def swin_ucf101_preset(**overrides) -> VittaConfig:
    """Preset matching reference tta_swin_ucf101.py:27-40."""
    cfg = VittaConfig(
        data=DataConfig(
            dataset="ucf101",
            clip_length=16,
            num_clips=1,
            frame_uniform=True,
            scale_size=224,          # tta_swin_ucf101.py:33
            input_size=224,
            input_mean=SWIN_IMG_NORM_MEAN,
            input_std=SWIN_IMG_NORM_STD,
        ),
        model=ModelConfig(
            arch="videoswintransformer",
            num_classes=101,
            patch_size=(2, 4, 4),
            window_size=(8, 7, 7),
        ),
        optim=OptimConfig(lr=1e-5),  # tta_swin_ucf101.py:38
        tta=TTAConfig(
            lambda_pred_consis=0.05,   # tta_swin_ucf101.py:39
            momentum_mvg=0.05,         # tta_swin_ucf101.py:40
            chosen_blocks=("backbone.layers.2", "backbone.layers.3", "backbone.norm"),
        ),
    )
    return cfg.replace(**overrides) if overrides else cfg


def num_classes_for(dataset: str) -> int:
    """Reference corpus/main_eval.py:39-47."""
    return {"ucf101": 101, "somethingv2": 174, "kinetics": 400}[dataset]


def _dataset_preset(arch: str, dataset: str, **overrides) -> VittaConfig:
    """Per-arch UCF101 preset re-targeted at another corruption dataset.

    The reference ships UCF101 drivers only; its per-arch hyperparameters
    (tta_{tanet,swin}_ucf101.py "To Specify" blocks) are dataset-
    independent, and the paper's SSv2-C / K400-C protocols reuse them —
    only the class count (main_eval.py:39-47) and, for SSv2, the flip
    label map (utils_.py:134-142) change."""
    base = (swin_ucf101_preset() if arch == "videoswintransformer"
            else tanet_ucf101_preset())
    cfg = base.replace(
        data=dataclasses.replace(base.data, dataset=dataset),
        model=dataclasses.replace(base.model, arch=arch,
                                  num_classes=num_classes_for(dataset)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def ssv2_preset(arch: str = "videoswintransformer", **overrides) -> VittaConfig:
    """Something-Something-v2-C preset (174 classes; SSv2's label-flip
    map applies wherever random horizontal flips are drawn — the live
    TTA view pipeline itself never flips, reference basics.py:1240-1259
    flip commented out / swin flip_ratio=0)."""
    return _dataset_preset(arch, "somethingv2", **overrides)


def kinetics_preset(arch: str = "videoswintransformer", **overrides) -> VittaConfig:
    """Kinetics-400-C preset (400 classes)."""
    return _dataset_preset(arch, "kinetics", **overrides)
