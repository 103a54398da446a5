"""Video datasets producing static-shaped numpy batches.

The port's copy of vitta_tpu/data/dataset.py, item for item: the same
per-index RNG (``SeedSequence(entropy=seed, spawn_key=(i,))``), samplers
and transforms give the same frames in both packages
(tests/test_torch_data_datasets.py holds them bit for bit).

Functional re-design of ``Video_TANetDataSet``
(models/tanet_models/video_dataset.py:28-358) and ``Video_SwinDataset``
(models/videoswintransformer_models/video_dataset.py:8-112): a dataset
is an indexable of per-video samples; all dynamism (frame counts, view
sampling) stays on the host, the device always sees static
``(n_views, T, S, S, 3)`` — float32 host-normalized, or uint8 with
``emit_uint8`` (the engine then normalizes on the device).

dataset_type:
* ``'tta'``  — augmented views (n_augmented_views x clip_len frames,
  per-view random spatial crop when if_spatial_rand_cropping);
* ``'eval'`` — deterministic views (test sampling x center crop or
  3-crop), used for the lock-step inference loader
  (corpus/basics.py:432-453).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from vitta_tpu_torch.config import VittaConfig, label_flip_map
from vitta_tpu_torch.data import native, sampling, transforms
from vitta_tpu_torch.data.records import VideoRecord, parse_list_file
from vitta_tpu_torch.data.video_reader import VideoSource


@dataclass
class Sample:
    frames: np.ndarray   # (n_views, T, S, S, 3) float32 normalized
    label: int
    index: int


class TANetVideoDataset:
    def __init__(self, cfg: VittaConfig, source: VideoSource,
                 records: Optional[List[VideoRecord]] = None,
                 dataset_type: str = "eval", seed: int = 0,
                 emit_uint8: bool = False):
        d, t = cfg.data, cfg.tta
        self.cfg = cfg
        self.source = source
        self.dataset_type = dataset_type
        self.emit_uint8 = emit_uint8  # the engine normalizes on the device
        if records is None:
            records = parse_list_file(d.val_vid_list, filter_short=True,
                                      debug=d.debug, debug_vid=d.debug_vid)
        self.records = records
        self.seed = seed
        self.clip_len = d.clip_length
        self.input_size = d.network_input_size
        self.scale_size = d.scale_size
        self.n_views = t.n_augmented_views
        self.view_style = t.tta_view_sample_style
        self.spatial_rand = t.if_spatial_rand_cropping
        self.sample_style = d.sample_style
        self.test_crops = d.test_crops
        self.mean, self.std = d.input_mean, d.input_std

    def __len__(self):
        return len(self.records)

    def _decode(self, rec: VideoRecord, indices: np.ndarray) -> np.ndarray:
        return self.source.get_batch(rec.path, indices)

    def _rng_for(self, i: int) -> np.random.Generator:
        """Per-index RNG: deterministic regardless of prefetch worker
        count or iteration order (the reference's DataLoader-worker RNG is
        worker-count dependent; this is strictly stronger)."""
        return np.random.default_rng(np.random.SeedSequence(
            entropy=self.seed, spawn_key=(i,)))

    def sample_indices(self, i: int):
        """Frame indices item ``i`` will decode, plus the RNG to finish
        building it with (``build``) — lets :class:`PairedTTADataset`
        decode the union of the tta+eval indices once per video."""
        rec = self.records[i]
        if self.dataset_type == "tta":
            rng = self._rng_for(i)
            idx = sampling.sample_tta_views(rec.num_frames, self.clip_len,
                                            self.view_style, self.n_views, rng)
            return idx, rng
        return sampling.sample_test(rec.num_frames, self.clip_len,
                                    self.sample_style), None

    def _tta_item(self, rec: VideoRecord, rng: np.random.Generator,
                  idx: Optional[np.ndarray] = None,
                  frames: Optional[np.ndarray] = None) -> np.ndarray:
        if idx is None:
            idx = sampling.sample_tta_views(rec.num_frames, self.clip_len,
                                            self.view_style, self.n_views, rng)
        if frames is None:
            frames = self._decode(rec, idx)      # (V*T or T, H, W, 3)
        if idx.shape[0] == self.clip_len:        # single-clip styles
            frames = np.tile(frames, (self.n_views, 1, 1, 1))
        views = frames.reshape(self.n_views, self.clip_len, *frames.shape[1:])
        if self.spatial_rand:
            views = transforms.subgroupwise_multiscale_crop(
                views, self.input_size, rng)
        else:
            views = np.stack([transforms.scale_center_crop(
                v, self.scale_size, self.input_size) for v in views])
        if self.emit_uint8:
            return views
        return transforms.normalize_clip(views, self.mean, self.std)

    def _eval_item(self, rec: VideoRecord,
                   idx: Optional[np.ndarray] = None,
                   frames: Optional[np.ndarray] = None) -> np.ndarray:
        if idx is None:
            idx = sampling.sample_test(rec.num_frames, self.clip_len,
                                       self.sample_style)
        if frames is None:
            frames = self._decode(rec, idx)
        n_clips = idx.shape[0] // self.clip_len
        clips = frames.reshape(n_clips, self.clip_len, *frames.shape[1:])
        out = []
        for clip in clips:
            if self.test_crops == 3:
                out.append(transforms.full_res_3crop(
                    clip, self.input_size, self.scale_size))
            else:
                out.append(transforms.scale_center_crop(
                    clip, self.scale_size, self.input_size)[None])
        views = np.concatenate(out, axis=0)      # (n_clips*crops, T, S, S, 3)
        if self.emit_uint8:
            return views
        return transforms.normalize_clip(views, self.mean, self.std)

    def build(self, i: int, idx: np.ndarray, frames: np.ndarray,
              rng: Optional[np.random.Generator]) -> Sample:
        """Finish item ``i`` from pre-decoded ``frames`` at ``idx``."""
        rec = self.records[i]
        if self.dataset_type == "tta":
            out = self._tta_item(rec, rng, idx=idx, frames=frames)
        elif self.dataset_type == "raw":
            # test-sampled frames with no crop/resize/normalize — DUA's
            # adaptation source (second dataset of the
            # get_dataset_tanet_dua pair, basics.py:1330-1347)
            return Sample(frames=frames.astype(np.uint8), label=rec.label,
                          index=i)
        else:
            out = self._eval_item(rec, idx=idx, frames=frames)
        dtype = np.uint8 if self.emit_uint8 else np.float32
        return Sample(frames=out.astype(dtype), label=rec.label, index=i)

    def __getitem__(self, i: int) -> Sample:
        idx, rng = self.sample_indices(i)
        frames = self._decode(self.records[i], idx)
        return self.build(i, idx, frames, rng)


class SwinVideoDataset:
    """mmaction-style pipeline for Video Swin
    (models/videoswintransformer_models/video_dataset.py:63-112):

    * eval: SampleFrames (frame_uniform SlowFast sampling or dense clips)
      -> Resize(-1, scale_size) (cv2-style bilinear, no antialias)
      -> CenterCrop(input_size) -> Normalize(0-255 stats);
    * tta: the shared TTA view samplers -> Resize(-1, scale_size)
      -> ONE RandomResizedCrop box shared by all frames and views
      -> Resize(input, input) -> Normalize.

    Output (n_views, T, S, S, 3) float32.
    """

    def __init__(self, cfg: VittaConfig, source: VideoSource,
                 records: Optional[List[VideoRecord]] = None,
                 dataset_type: str = "eval", seed: int = 0,
                 emit_uint8: bool = False):
        d, t = cfg.data, cfg.tta
        self.cfg = cfg
        self.source = source
        self.dataset_type = dataset_type
        self.emit_uint8 = emit_uint8
        if records is None:
            records = parse_list_file(d.val_vid_list, filter_short=False,
                                      debug=d.debug, debug_vid=d.debug_vid)
        self.records = records
        self.seed = seed
        self.clip_len = d.clip_length
        self.input_size = d.input_size
        self.scale_size = d.scale_size
        self.num_clips = d.num_clips
        self.frame_uniform = d.frame_uniform
        self.frame_interval = d.frame_interval
        self.n_views = t.n_augmented_views
        self.view_style = t.tta_view_sample_style
        self.mean, self.std = d.input_mean, d.input_std

    def __len__(self):
        return len(self.records)

    def _short_dims(self, h: int, w: int) -> Tuple[int, int]:
        """Output dims of the short-side-to-scale_size resize (identity
        when the short side already matches)."""
        if min(h, w) == self.scale_size:
            return h, w
        if w < h:
            return int(self.scale_size * h / w + 0.5), self.scale_size
        return self.scale_size, int(self.scale_size * w / h + 0.5)

    def _resize_short_crop(self, frames: np.ndarray, y0: int, x0: int,
                           ch: int, cw: int) -> np.ndarray:
        """Short-side resize then crop, fused: only the pixels inside the
        crop window are resampled (bit-identical to resize-then-crop —
        csrc resize_bilinear_u8_window).  Skips the resample entirely
        when the short side already matches scale_size."""
        h, w = frames.shape[1:3]
        oh, ow = self._short_dims(h, w)
        if (oh, ow) == (h, w):
            return native.crop(frames, y0, x0, ch, cw)
        return native.resize_bilinear_window(frames, oh, ow, y0, x0, ch, cw,
                                             antialias=False)

    def sample_indices(self, i: int):
        """Frame indices item ``i`` will decode + the RNG ``build`` needs
        (see :meth:`TANetVideoDataset.sample_indices`)."""
        rec = self.records[i]
        if self.dataset_type == "tta":
            rng = np.random.default_rng(np.random.SeedSequence(
                entropy=self.seed, spawn_key=(i,)))
            return sampling.sample_tta_views(rec.num_frames, self.clip_len,
                                             self.view_style, self.n_views,
                                             rng), rng
        if self.dataset_type == "raw" or self.frame_uniform:
            return sampling.sample_seq_frames(rec.num_frames, self.clip_len,
                                              test_mode=True), None
        return sampling.sample_dense_clips_test(
            rec.num_frames, self.clip_len, self.frame_interval,
            self.num_clips), None

    def build(self, i: int, idx: np.ndarray, frames: np.ndarray,
              rng: Optional[np.random.Generator]) -> Sample:
        rec = self.records[i]
        if self.dataset_type == "raw":
            return Sample(frames=frames.astype(np.uint8), label=rec.label,
                          index=i)
        if self.dataset_type == "tta":
            h, w = self._short_dims(*frames.shape[1:3])
            # one crop box for ALL frames/views (transforms_backup.py:193-349)
            x, y, cw, ch = transforms.random_resized_crop_bbox(h, w, rng)
            frames = self._resize_short_crop(frames, y, x, ch, cw)
            frames = native.resize_bilinear(frames, self.input_size,
                                            self.input_size, antialias=False)
            n_views = (idx.shape[0] // self.clip_len)
            views = frames.reshape(n_views, self.clip_len, *frames.shape[1:])
            if n_views == 1 and self.n_views > 1:
                views = np.tile(views, (self.n_views, 1, 1, 1, 1))
        else:
            h, w = self._short_dims(*frames.shape[1:3])
            yy = (h - self.input_size) // 2
            xx = (w - self.input_size) // 2
            frames = self._resize_short_crop(frames, yy, xx,
                                             self.input_size, self.input_size)
            n_clips = idx.shape[0] // self.clip_len
            views = frames.reshape(n_clips, self.clip_len, *frames.shape[1:])
        if self.emit_uint8:
            return Sample(frames=views.astype(np.uint8), label=rec.label,
                          index=i)
        out = transforms.normalize_clip(views, self.mean, self.std,
                                        scale_255=False)
        return Sample(frames=out.astype(np.float32), label=rec.label, index=i)

    def __getitem__(self, i: int) -> Sample:
        idx, rng = self.sample_indices(i)
        frames = self.source.get_batch(self.records[i].path, idx)
        return self.build(i, idx, frames, rng)


class LegacyVideoDataset:
    """The deprecated I3D-era video loaders — ``MyVideoDataset``
    (consecutive-frame windows) and ``MyTSNVideoDataset`` (legacy
    TSN-uniform sampling), datasets_/video_dataset.py:30-312 — together
    with the legacy ``get_dataset`` transform stacks
    (corpus/basics.py:1350-1444):

    * ``dataset_type='train'``: random sampling + the training
      augmentation (shared GroupMultiScaleCrop + 0.5-probability flip
      with direction-sensitive label swap, utils/utils_.py:124-168);
    * ``dataset_type='eval'``: deterministic sampling +
      GroupScale(scale_size) -> GroupCenterCrop(input_size);
    * ``dataset_type='raw'``: sampled frames untouched (the DUA
      adaptation source of the legacy pair, basics.py:1407-1421).

    ``tsn_style`` picks the sampler (the reference's undeclared
    ``args.tsn_style`` flag, basics.py:1372); when left ``None`` it
    reads ``cfg.data.tsn_style``, so the config knob governs every
    construction path (incl. PairedTTADataset / dataset_cls_for, which
    pass only the class).  Output ``(num_clips, T, S, S, 3)``,
    channels-last, float32 normalized or uint8 with ``emit_uint8``."""

    def __init__(self, cfg: VittaConfig, source: VideoSource,
                 records: Optional[List[VideoRecord]] = None,
                 dataset_type: str = "eval", seed: int = 0,
                 emit_uint8: bool = False, tsn_style: Optional[bool] = None):
        d = cfg.data
        self.cfg = cfg
        self.source = source
        # 'tta' is the PairedTTADataset label for its views half; the
        # legacy loaders have no TTA-view mode (main_eval.py guards
        # legacy_loader+tta), so it deliberately aliases the
        # deterministic eval pipeline for the baseline-only pairing.
        if dataset_type not in ("train", "eval", "raw", "tta"):
            raise ValueError(f"LegacyVideoDataset: unknown dataset_type "
                             f"{dataset_type!r}")
        self.dataset_type = dataset_type
        self.emit_uint8 = emit_uint8
        if records is None:
            list_file = d.val_vid_list
            records = parse_list_file(list_file, filter_short=False,
                                      debug=d.debug, debug_vid=d.debug_vid)
        self.records = records
        self.seed = seed
        self.tsn_style = d.tsn_style if tsn_style is None else tsn_style
        self.clip_len = d.clip_length
        self.frame_interval = d.frame_interval
        self.num_clips = d.num_clips
        self.input_size = d.network_input_size
        self.scale_size = d.scale_size
        self.mean, self.std = d.input_mean, d.input_std
        self.label_flip = label_flip_map(d.dataset)

    def __len__(self):
        return len(self.records)

    def _rng_for(self, i: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            entropy=self.seed, spawn_key=(i,)))

    def sample_indices(self, i: int):
        rec = self.records[i]
        test_mode = self.dataset_type != "train"
        rng = None if test_mode else self._rng_for(i)
        if self.tsn_style:
            idx = sampling.sample_legacy_tsn(
                rec.num_frames, self.clip_len, self.num_clips,
                test_mode=test_mode, rng=rng)
        else:
            idx = sampling.sample_legacy_consecutive(
                rec.num_frames, self.clip_len, self.frame_interval,
                self.num_clips, test_mode=test_mode, rng=rng)
        return idx, (rng if not test_mode else self._rng_for(i))

    def build(self, i: int, idx: np.ndarray, frames: np.ndarray,
              rng: Optional[np.random.Generator]) -> Sample:
        rec = self.records[i]
        label = rec.label
        if self.dataset_type == "raw":
            return Sample(frames=frames.astype(np.uint8), label=label,
                          index=i)
        if self.dataset_type == "train":
            # one shared crop box + flip decision across every frame of
            # every clip (group transforms see the full PIL list,
            # basics.py:1353-1357)
            frames, label = transforms.train_augment(
                frames, label, self.input_size, rng,
                label_transforms=self.label_flip)
        else:
            frames = transforms.scale_center_crop(
                frames, self.scale_size, self.input_size)
        n_clips = idx.shape[0] // self.clip_len
        out = frames.reshape(n_clips, self.clip_len, *frames.shape[1:])
        if not self.emit_uint8:
            out = transforms.normalize_clip(out, self.mean, self.std)
        dtype = np.uint8 if self.emit_uint8 else np.float32
        return Sample(frames=out.astype(dtype), label=label, index=i)

    def __getitem__(self, i: int) -> Sample:
        idx, rng = self.sample_indices(i)
        frames = self.source.get_batch(self.records[i].path, idx)
        return self.build(i, idx, frames, rng)


def dataset_cls_for(arch: str, legacy_loader: bool = False):
    """Dataset routing per arch (main_eval.py:102-227): Swin has its own
    mmaction-style pipeline; TANet's dataset also serves the secondary
    archs unless ``legacy_loader`` opts into the deprecated I3D-era
    loaders (the reference's ``get_dataset`` 'vid' path,
    basics.py:1350-1444).  TANet has no legacy pipeline (the reference
    always routes it through get_dataset_tanet, main_eval.py:102-122),
    so ``legacy_loader`` with arch='tanet' is a misconfiguration and
    fails loudly instead of silently falling back."""
    if arch == "videoswintransformer":
        return SwinVideoDataset
    if legacy_loader:
        if arch == "tanet":
            raise ValueError(
                "legacy_loader is not valid for arch='tanet': the "
                "reference has no legacy TANet pipeline "
                "(corpus/main_eval.py:102-122 always uses "
                "get_dataset_tanet). Drop data.legacy_loader.")
        return LegacyVideoDataset
    return TANetVideoDataset


class PairedTTADataset:
    """Lock-step (tta views, eval clip) pairs of the same video — the
    reference iterates two DataLoaders in parallel (basics.py:475, 693).

    Both halves read the same video, so the decode is fused: ONE
    ``get_batch`` on the sorted union of the tta+eval frame indices,
    then frames are distributed to each half.  Video decoders pay per
    frame *decoded*, not per frame returned (inter-frame dependencies
    force a forward decode from the preceding keyframe), so two
    separate calls decode most of the video twice — measured ~1.9x the
    decode cost of the union call on a 250-frame mpeg4
    (benchmarks/PERF.md host section).  ``fuse_decode=False`` restores
    the two-call behavior (used by its equivalence test)."""

    def __init__(self, cfg: VittaConfig, source: VideoSource,
                 records: Optional[List[VideoRecord]] = None, seed: int = 0,
                 dataset_cls=TANetVideoDataset, emit_uint8: bool = False,
                 fuse_decode: bool = True):
        self.tta = dataset_cls(cfg, source, records, dataset_type="tta",
                               seed=seed, emit_uint8=emit_uint8)
        self.eval = dataset_cls(cfg, source, self.tta.records, dataset_type="eval",
                                seed=seed + 1, emit_uint8=emit_uint8)
        self.source = source
        self.fuse_decode = fuse_decode

    def __len__(self):
        return len(self.tta)

    def __getitem__(self, i: int):
        if self.fuse_decode:
            t_idx, t_rng = self.tta.sample_indices(i)
            e_idx, e_rng = self.eval.sample_indices(i)
            union = np.unique(np.concatenate([t_idx, e_idx]))
            frames = self.source.get_batch(self.tta.records[i].path, union)
            a = self.tta.build(i, t_idx, frames[np.searchsorted(union, t_idx)],
                               t_rng)
            b = self.eval.build(i, e_idx,
                                frames[np.searchsorted(union, e_idx)], e_rng)
        else:
            a, b = self.tta[i], self.eval[i]
        return a.frames, b.frames, np.asarray([a.label], np.int32)
