"""Temporal frame-sampling policies, as pure numpy functions.

The port's copy of vitta_tpu/data/sampling.py, function for function
(tests/test_torch_data_sampling.py holds every sampler to it index for
index).  Replicates — formula for formula, including the reference's
off-by-one quirks — the samplers of:

* ``Video_TANetDataSet`` (models/tanet_models/video_dataset.py:159-303):
  train TSN-random, val middle-frame, test ``uniform-N`` / ``dense-N``,
  and the 7 TTA augmented-view styles.
* ``SampleFrames.get_seq_frames`` — SlowFast-style uniform sampling used
  by the Swin eval pipeline
  (models/videoswintransformer_models/transforms_backup.py:550-569), and
  ``SampleFrames._get_test_clips`` dense clips (:509-533).

Index convention: most reference samplers return **1-based** offsets
(``np.array(offsets) + 1``) that are then used directly as **0-based**
decode indices after clamping to ``n_frames - 1``
(video_dataset.py:320-330, transforms_backup.py:688).  We reproduce that
exact behavior: every function here returns ready-to-decode 0-based
indices with the same clamp applied, so decoded frames match the
reference bit-for-bit.

All randomness comes from an explicit ``np.random.Generator`` so runs
are reproducible and CI is deterministic.
"""

from __future__ import annotations

import numpy as np

TTA_VIEW_STYLES = (
    "uniform", "dense", "uniform_equidist", "dense_equidist",
    "uniform_rand", "dense_rand", "random",
)


def _clamp(indices: np.ndarray, num_frames: int) -> np.ndarray:
    """decord index clamp (video_dataset.py:328)."""
    return np.minimum(np.asarray(indices, dtype=np.int64), num_frames - 1)


# ---------------------------------------------------------------------------
# TANet-style samplers (clip_len frames via `num_segments` segments)
# ---------------------------------------------------------------------------

def sample_train_tsn(num_frames: int, clip_len: int,
                     rng: np.random.Generator, new_length: int = 1) -> np.ndarray:
    """TSN training sampling (video_dataset.py:243-251): uniformly divide
    into segments, random frame per segment."""
    average_duration = (num_frames - new_length + 1) // clip_len
    if average_duration > 0:
        offsets = (np.arange(clip_len) * average_duration
                   + rng.integers(0, average_duration, size=clip_len))
    elif num_frames > clip_len:
        offsets = np.sort(rng.integers(0, num_frames - new_length + 1, size=clip_len))
    else:
        offsets = np.zeros((clip_len,), dtype=np.int64)
    return _clamp(offsets + 1, num_frames)


def sample_train_dense(num_frames: int, clip_len: int,
                       rng: np.random.Generator) -> np.ndarray:
    """I3D dense training sampling (video_dataset.py:236-242)."""
    t_stride = 64 // clip_len
    sample_pos = max(1, 1 + num_frames - t_stride * clip_len)
    start_idx = 0 if sample_pos == 1 else int(rng.integers(0, sample_pos - 1))
    offsets = [(idx * t_stride + start_idx) % num_frames for idx in range(clip_len)]
    return _clamp(np.array(offsets) + 1, num_frames)


def sample_val_uniform(num_frames: int, clip_len: int, new_length: int = 1) -> np.ndarray:
    """Validation middle-frame sampling (video_dataset.py:263-269)."""
    if num_frames > clip_len + new_length - 1:
        tick = (num_frames - new_length + 1) / float(clip_len)
        offsets = np.array([int(tick / 2.0 + tick * x) for x in range(clip_len)])
    else:
        offsets = np.zeros((clip_len,), dtype=np.int64)
    return _clamp(offsets + 1, num_frames)


def sample_test(num_frames: int, clip_len: int, sample_style: str,
                new_length: int = 1) -> np.ndarray:
    """Multi-clip test sampling, ``'uniform-N'`` or ``'dense-N'``
    (video_dataset.py:271-303).  Returns concatenated indices of all
    clips, shape (N*clip_len,)."""
    kind, n = sample_style.split("-")
    num_clips = int(n)
    if kind == "dense":
        t_stride = 64 // clip_len
        sample_pos = max(1, 1 + num_frames - t_stride * clip_len)
        if num_clips == 1:
            start_idx = sample_pos // 2
            offsets = [(idx * t_stride + start_idx) % num_frames
                       for idx in range(clip_len)]
        else:
            start_list = np.linspace(0, sample_pos - 1, num=num_clips, dtype=int)
            offsets = []
            for start_idx in start_list.tolist():
                offsets += [(idx * t_stride + start_idx) % num_frames
                            for idx in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    elif kind == "uniform":
        tick = (num_frames - new_length + 1) / float(clip_len)
        if num_clips == 1:
            offsets = [int(tick / 2.0 + tick * x) for x in range(clip_len)]
        else:
            start_list = np.linspace(0, tick - 1, num=num_clips, dtype=int)
            offsets = []
            for start_idx in start_list.tolist():
                offsets += [int(start_idx + tick * x) % num_frames
                            for x in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    raise NotImplementedError(f"sample_style={sample_style}")


# ---------------------------------------------------------------------------
# TTA augmented-view samplers (shared by TANet and Swin pipelines:
# video_dataset.py:159-230 == transforms_backup.py:571-641)
# ---------------------------------------------------------------------------

def sample_tta_views(num_frames: int, clip_len: int, style: str,
                     n_views: int, rng: np.random.Generator | None = None,
                     new_length: int = 1) -> np.ndarray:
    """Frame indices for the TTA augmented views; for the *_equidist
    styles the views' indices are concatenated: shape (n_views*clip_len,)
    — otherwise (clip_len,)."""
    if style == "uniform":
        tick = (num_frames - new_length + 1) / float(clip_len)
        offsets = [int(tick / 2.0 + tick * x) for x in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    if style == "dense":
        t_stride = 64 // clip_len
        sample_pos = max(1, 1 + num_frames - t_stride * clip_len)
        start_idx = sample_pos // 2
        offsets = [(idx * t_stride + start_idx) % num_frames for idx in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    if style == "uniform_equidist":
        # default live style (opts.py:90): equidistant start offsets in the
        # first segment, one uniform clip per view, indices concatenated.
        tick = (num_frames - new_length + 1) / float(clip_len)
        start_list = np.linspace(0, tick - 1, num=n_views, dtype=int)
        offsets = []
        for start_idx in start_list.tolist():
            offsets += [int(start_idx + tick * x) % num_frames for x in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    if style == "dense_equidist":
        t_stride = 64 // clip_len
        sample_pos = max(1, 1 + num_frames - t_stride * clip_len)
        start_list = np.linspace(0, sample_pos - 1, num=n_views, dtype=int)
        offsets = []
        for start_idx in start_list.tolist():
            offsets += [(idx * t_stride + start_idx) % num_frames
                        for idx in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    if style == "uniform_rand":
        assert rng is not None
        average_duration = (num_frames - new_length + 1) // clip_len
        if average_duration > 0:
            offsets = (np.arange(clip_len) * average_duration
                       + rng.integers(0, average_duration, size=clip_len))
        elif num_frames > clip_len:
            offsets = np.sort(rng.integers(0, num_frames - new_length + 1, size=clip_len))
        else:
            offsets = np.zeros((clip_len,), dtype=np.int64)
        return _clamp(offsets + 1, num_frames)
    if style == "dense_rand":
        assert rng is not None
        t_stride = 64 // clip_len
        sample_pos = max(1, 1 + num_frames - t_stride * clip_len)
        start_idx = 0 if sample_pos == 1 else int(rng.integers(0, sample_pos - 1))
        offsets = [(idx * t_stride + start_idx) % num_frames for idx in range(clip_len)]
        return _clamp(np.array(offsets) + 1, num_frames)
    if style == "random":
        assert rng is not None
        if num_frames >= clip_len:
            offsets = np.sort(rng.choice(num_frames, size=clip_len, replace=False))
        else:
            offsets = np.array(list(range(num_frames))
                               + [num_frames - 1] * (clip_len - num_frames))
        # NB: the 'random' style is the one sampler that does NOT add +1
        # (video_dataset.py:230).
        return _clamp(np.array(offsets), num_frames)
    raise NotImplementedError(f"tta view style={style}")


# ---------------------------------------------------------------------------
# Swin (mmaction-style) samplers
# ---------------------------------------------------------------------------

def sample_seq_frames(num_frames: int, clip_len: int, test_mode: bool = True,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """SlowFast-style uniform sampling (transforms_backup.py:550-569):
    divide [0, num_frames-1] into clip_len segments; middle frame per
    segment in test mode, random frame per segment otherwise."""
    seg_size = float(num_frames - 1) / clip_len
    seq = []
    for i in range(clip_len):
        start = int(np.round(seg_size * i))
        end = int(np.round(seg_size * (i + 1)))
        if test_mode:
            seq.append((start + end) // 2)
        else:
            assert rng is not None
            seq.append(int(rng.integers(start, end + 1)))
    return _clamp(np.array(seq), num_frames)


def sample_dense_clips_test(num_frames: int, clip_len: int, frame_interval: int,
                            num_clips: int, twice_sample: bool = False) -> np.ndarray:
    """mmaction SampleFrames test-mode dense clips
    (transforms_backup.py:509-533 + __call__ loop handling :676-686).
    Returns concatenated (num_clips*clip_len,) indices with 'loop'
    out-of-bound handling."""
    ori_clip_len = clip_len * frame_interval
    avg_interval = (num_frames - ori_clip_len + 1) / float(num_clips)
    if num_frames > ori_clip_len - 1:
        base_offsets = np.arange(num_clips) * avg_interval
        clip_offsets = (base_offsets + avg_interval / 2.0).astype(np.int64)
        if twice_sample:
            clip_offsets = np.concatenate([clip_offsets, base_offsets.astype(np.int64)])
    else:
        clip_offsets = np.zeros((num_clips,), dtype=np.int64)
    frame_inds = clip_offsets[:, None] + np.arange(clip_len)[None, :] * frame_interval
    frame_inds = np.mod(frame_inds, num_frames)
    return _clamp(np.concatenate(frame_inds), num_frames)


# ---------------------------------------------------------------------------
# Legacy I3D-era samplers (datasets_/video_dataset.py)
# ---------------------------------------------------------------------------

def sample_legacy_consecutive(num_frames: int, clip_len: int,
                              frame_interval: int = 1, num_clips: int = 1,
                              test_mode: bool = False,
                              rng: np.random.Generator | None = None
                              ) -> np.ndarray:
    """``MyVideoDataset`` consecutive-window sampling
    (datasets_/video_dataset.py:79-125): ``num_clips`` windows of
    ``clip_len`` frames with stride ``frame_interval``; train mode
    randomizes each window's start within its share of the video, test
    mode centers the windows.  Indices wrap modulo ``num_frames``
    (:123) — no +1 offset and no clamp in this family.  Returns
    concatenated (num_clips*clip_len,) 0-based decode indices."""
    ori_clip_len = clip_len * frame_interval
    if test_mode:
        # :100-108 (modern-dtype equivalent of the removed np.int)
        avg_interval = (num_frames - ori_clip_len + 1) / float(num_clips)
        if num_frames > ori_clip_len - 1:
            base = np.arange(num_clips) * avg_interval
            offsets = (base + avg_interval / 2.0).astype(np.int64)
        else:
            offsets = np.zeros((num_clips,), dtype=np.int64)
    else:
        assert rng is not None, "train mode needs an rng"
        # :79-98, branch order preserved (avg_interval may be negative
        # for clips longer than the video -> final zeros branch)
        avg_interval = (num_frames - ori_clip_len + 1) // num_clips
        if avg_interval > 0:
            base = np.arange(num_clips) * avg_interval
            offsets = base + rng.integers(0, avg_interval, size=num_clips)
        elif num_frames > max(num_clips, ori_clip_len):
            offsets = np.sort(rng.integers(
                0, num_frames - ori_clip_len + 1, size=num_clips))
        elif avg_interval == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / num_clips
            offsets = np.around(np.arange(num_clips) * ratio).astype(np.int64)
        else:
            offsets = np.zeros((num_clips,), dtype=np.int64)
    inds = offsets[:, None] + np.arange(clip_len)[None, :] * frame_interval
    return np.mod(np.concatenate(inds), num_frames).astype(np.int64)


def sample_legacy_tsn(num_frames: int, clip_len: int, num_clips: int = 1,
                      test_mode: bool = False,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """``MyTSNVideoDataset`` legacy TSN-uniform sampling
    (datasets_/video_dataset.py:240-287): the video is divided into
    ``clip_len`` segments whose lengths differ by at most one (the
    remainder goes to the FIRST segments, ``uniform_divide_segment``
    :240-248); train mode draws one random frame per segment with
    *inclusive* borders (:250-270), test mode takes
    ``arange(clip_len)*floor(n/clip_len) + floor(seg_len/2)`` for a
    single clip regardless of ``num_clips`` (:272-286).  Videos shorter
    than ``clip_len`` repeat the last frame.  Indices are 0-based and
    clamped like the loader's decode (:301)."""
    if test_mode:
        if num_frames >= clip_len:
            seg_len = num_frames // clip_len
            half = int(np.floor(seg_len / 2.0))
            sel = np.arange(clip_len) * seg_len + half
        else:
            sel = np.concatenate([
                np.arange(num_frames),
                np.full((clip_len - num_frames,), num_frames - 1)])
        out = sel[None, :]
    else:
        assert rng is not None, "train mode needs an rng"
        out = np.zeros((num_clips, clip_len), dtype=np.int64)
        if num_frames >= clip_len:
            seg_len = num_frames // clip_len
            seg_lens = np.full((clip_len,), seg_len, dtype=np.int64)
            seg_lens[: num_frames - seg_len * clip_len] += 1
            ends = np.cumsum(seg_lens)
            starts = ends - seg_lens
            for c in range(num_clips):
                # random.randint(start, end) has inclusive borders
                out[c] = [int(rng.integers(s, e)) for s, e in zip(starts, ends)]
        else:
            out[:] = np.concatenate([
                np.arange(num_frames),
                np.full((clip_len - num_frames,), num_frames - 1)])
    return _clamp(out.reshape(-1), num_frames)
