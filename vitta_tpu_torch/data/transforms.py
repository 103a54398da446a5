"""Host-side frame transforms (crop / resize / normalize).

The port's copy of vitta_tpu/data/transforms.py, function for function.
Replicates the reference TANet group transforms
(models/tanet_models/transforms.py):

* ``GroupScale_TANet`` (:170) — PIL bilinear resize of the shorter side
  (aspect preserved);
* ``GroupCenterCrop_TANet`` (:46) — torchvision CenterCrop;
* ``SubgroupWise_MultiScaleCrop_TANet`` (:277-359) — per temporal view,
  a random (scale, offset) from the fixed TSN offset grid, crop then
  bilinear resize to input_size.  Scales {1, .875, .75, .66} of the
  shorter side, max_distort 1, more_fix_crop 13-offset grid;
* ``Stack_TANet`` + ``ToTorchFormatTensor_TANet`` + ``GroupNormalize_TANet``
  (:637-686, 140-152) — /255 then per-channel (x-mean)/std.  We emit
  ``(T, H, W, 3)`` float32 directly (channels-last; the reference's
  channel-stacked layout is just a reshape away).

Resampling runs through the port's native C++ library
(vitta_tpu_torch/csrc/host/vitta_host.cpp, PIL-exact with antialias,
cv2-exact without), which raises where it cannot be built: no PIL
fallback.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from vitta_tpu_torch.data import native

DEFAULT_SCALES = (1.0, 0.875, 0.75, 0.66)


def resize_shorter_side(frame: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize so the shorter edge equals ``size`` (PIL BILINEAR
    semantics, through the native library)."""
    h, w = frame.shape[:2]
    if (w <= h and w == size) or (h <= w and h == size):
        return frame
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    return native.resize_bilinear(frame, oh, ow)


def center_crop(frame: np.ndarray, size: int) -> np.ndarray:
    h, w = frame.shape[:2]
    th = tw = size
    y = int(round((h - th) / 2.0))
    x = int(round((w - tw) / 2.0))
    return frame[y:y + th, x:x + tw]


def crop_and_resize(frames: np.ndarray, box: Tuple[int, int, int, int],
                    out_size: Tuple[int, int]) -> np.ndarray:
    """Crop (x, y, w, h) then bilinear resize each frame to out_size
    (w, h). frames: (T, H, W, 3) uint8."""
    x, y, w, h = box
    out_w, out_h = out_size
    cropped = native.crop(np.ascontiguousarray(frames), y, x, h, w)
    return native.resize_bilinear(cropped, out_h, out_w)


def fill_fix_offsets(more_fix_crop: bool, image_w: int, image_h: int,
                     crop_w: int, crop_h: int) -> List[Tuple[int, int]]:
    """The TSN fixed offset grid (transforms.py:362-388)."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
           (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        ret += [(0, 2 * h_step), (4 * w_step, 2 * h_step),
                (2 * w_step, 4 * h_step), (2 * w_step, 0),
                (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return ret


def sample_multiscale_crop(image_w: int, image_h: int, input_size: Tuple[int, int],
                           rng: np.random.Generator,
                           scales: Sequence[float] = DEFAULT_SCALES,
                           max_distort: int = 1,
                           fix_crop: bool = True,
                           more_fix_crop: bool = True) -> Tuple[int, int, int, int]:
    """One random (x, y, w, h) crop box per the reference's
    ``_sample_crop_size`` (transforms.py:325-359)."""
    base_size = min(image_w, image_h)
    crop_sizes = [int(base_size * s) for s in scales]
    crop_h = [input_size[1] if abs(c - input_size[1]) < 3 else c for c in crop_sizes]
    crop_w = [input_size[0] if abs(c - input_size[0]) < 3 else c for c in crop_sizes]
    pairs = [(w, h) for i, h in enumerate(crop_h) for j, w in enumerate(crop_w)
             if abs(i - j) <= max_distort]
    cw, ch = pairs[rng.integers(0, len(pairs))]
    if not fix_crop:
        ox = int(rng.integers(0, image_w - cw + 1))
        oy = int(rng.integers(0, image_h - ch + 1))
    else:
        offsets = fill_fix_offsets(more_fix_crop, image_w, image_h, cw, ch)
        ox, oy = offsets[rng.integers(0, len(offsets))]
    return ox, oy, cw, ch


def subgroupwise_multiscale_crop(view_frames: np.ndarray, input_size: int,
                                 rng: np.random.Generator,
                                 scales: Sequence[float] = DEFAULT_SCALES) -> np.ndarray:
    """Per-view independent random multi-scale crop
    (SubgroupWise_MultiScaleCrop_TANet, transforms.py:277-324).

    view_frames: (V, T, H, W, 3) uint8 -> (V, T, input, input, 3) uint8.
    """
    v, t, h, w, c = view_frames.shape
    out = np.empty((v, t, input_size, input_size, c), np.uint8)
    for vi in range(v):
        box = sample_multiscale_crop(w, h, (input_size, input_size), rng, scales)
        out[vi] = crop_and_resize(view_frames[vi], box, (input_size, input_size))
    return out


def scale_center_crop(frames: np.ndarray, scale_size: int, crop_size: int) -> np.ndarray:
    """Deterministic eval pipeline: Scale(shorter side) + CenterCrop
    (corpus/basics.py:1260-1263). frames: (T, H, W, 3) uint8 (all frames
    the same size, so the batch resizes in one native call)."""
    h, w = frames.shape[1:3]
    if w < h:
        ow, oh = scale_size, int(scale_size * h / w)
    elif h < w:
        oh, ow = scale_size, int(scale_size * w / h)
    else:
        oh = ow = scale_size
    y = int(round((oh - crop_size) / 2.0))
    x = int(round((ow - crop_size) / 2.0))
    if (oh, ow) == (h, w):
        return native.crop(np.ascontiguousarray(frames), y, x,
                           crop_size, crop_size)
    # fused: only the center window's pixels are resampled (~43% of the
    # full resize skipped at 256->224 geometry), bit-identical output
    return native.resize_bilinear_window(frames, oh, ow, y, x,
                                         crop_size, crop_size)


def full_res_3crop(frames: np.ndarray, crop_size: int, scale_size: int) -> np.ndarray:
    """GroupFullResSample 3-crop (transforms.py:227-275): scale shorter
    side then left/center/right (or top/center/bottom) crops.
    frames: (T, H, W, 3) -> (3, T, crop, crop, 3)."""
    t = frames.shape[0]
    scaled = np.stack([resize_shorter_side(f, scale_size) for f in frames])
    h, w = scaled.shape[1:3]
    w_step = (w - crop_size) // 4
    h_step = (h - crop_size) // 4
    offsets = [(0 * w_step, 2 * h_step), (4 * w_step, 2 * h_step),
               (2 * w_step, 2 * h_step)]
    out = np.empty((3, t, crop_size, crop_size, 3), np.uint8)
    for ci, (ox, oy) in enumerate(offsets):
        out[ci] = scaled[:, oy:oy + crop_size, ox:ox + crop_size]
    return out


def oversample_10crop(frames: np.ndarray, crop_size: int,
                      scale_size: Optional[int] = None) -> np.ndarray:
    """GroupOverSample 10-crop (transforms.py:194-225): the 5 fixed TSN
    offsets (corners + center) each with its horizontal flip.
    frames: (T, H, W, 3) -> (10, T, crop, crop, 3)."""
    if scale_size is not None:
        frames = np.stack([resize_shorter_side(f, scale_size) for f in frames])
    h, w = frames.shape[1:3]
    offsets = fill_fix_offsets(False, w, h, crop_size, crop_size)
    out = np.empty((2 * len(offsets), frames.shape[0], crop_size, crop_size, 3),
                   np.uint8)
    for i, (ox, oy) in enumerate(offsets):
        crop = frames[:, oy:oy + crop_size, ox:ox + crop_size]
        out[2 * i] = crop
        out[2 * i + 1] = crop[:, :, ::-1]
    return out


def subgroupwise_hflip(view_frames: np.ndarray, label: int,
                       label_transforms: Optional[dict],
                       rng: np.random.Generator) -> np.ndarray:
    """Per-temporal-view random horizontal flip
    (SubgroupWise_RandomHorizontalFlip_TANet, transforms.py:56-100):
    each view flips independently with p=0.5; skipped entirely when the
    label is direction-sensitive (in the label map)."""
    if label_transforms is not None and label in label_transforms:
        return view_frames
    out = view_frames.copy()
    for vi in range(view_frames.shape[0]):
        if rng.random() < 0.5:
            out[vi] = out[vi, :, :, ::-1]
    return out


def random_resized_crop_bbox(img_h: int, img_w: int,
                             rng: np.random.Generator,
                             area_range=(0.08, 1.0),
                             aspect_ratio_range=(3 / 4, 4 / 3),
                             max_attempts: int = 10) -> Tuple[int, int, int, int]:
    """mmaction RandomResizedCrop bbox (transforms_backup.py:224-273):
    log-uniform aspect ratios, uniform areas, 10 attempts, center-square
    fallback.  Returns (x, y, w, h); the Swin TTA pipeline samples ONE
    box shared by all frames and views."""
    area = img_h * img_w
    min_ar, max_ar = aspect_ratio_range
    ars = np.exp(rng.uniform(np.log(min_ar), np.log(max_ar), size=max_attempts))
    tareas = rng.uniform(*area_range, size=max_attempts) * area
    cw = np.round(np.sqrt(tareas * ars)).astype(np.int64)
    ch = np.round(np.sqrt(tareas / ars)).astype(np.int64)
    for i in range(max_attempts):
        if ch[i] <= img_h and cw[i] <= img_w:
            x = int(rng.integers(0, img_w - cw[i] + 1))
            y = int(rng.integers(0, img_h - ch[i] + 1))
            return x, y, int(cw[i]), int(ch[i])
    size = min(img_h, img_w)
    return (img_w - size) // 2, (img_h - size) // 2, size, size


def hflip_with_label(frames: np.ndarray, label: int,
                     label_transforms: Optional[dict],
                     rng: np.random.Generator,
                     flip_ratio: float = 0.5,
                     mode: str = "skip") -> Tuple[np.ndarray, int]:
    """Group horizontal flip with the SSv2 label-swap map.

    The reference carries two semantics for direction-sensitive classes
    (those in the map):

    * ``mode='skip'`` — the TANet SubgroupWise variant
      (tanet_models/transforms.py:56-87): mapped labels are never
      flipped;
    * ``mode='swap'`` — the generic ``GroupRandomHorizontalFlip`` and
      ``GroupRandomHorizontalFlip_TANet`` used by ``get_augmentation``
      (utils/utils_.py:124-168, tanet transforms.py:95-117): the frames
      flip and the label swaps ("left to right" becomes "right to
      left")."""
    if mode == "skip" and label_transforms is not None \
            and label in label_transforms:
        return frames, label
    if rng.random() < flip_ratio:
        if mode == "swap" and label_transforms is not None:
            label = label_transforms.get(label, label)
        return frames[..., ::-1, :].copy(), label
    return frames, label


def train_augment(frames: np.ndarray, label: int, input_size: int,
                  rng: np.random.Generator,
                  label_transforms: Optional[dict] = None
                  ) -> Tuple[np.ndarray, int]:
    """The reference's training augmentation (``get_augmentation``,
    utils/utils_.py:124-168, used by the legacy trainer at
    basics.py:1351): GroupMultiScaleCrop from scales {1,.875,.75,.66}
    followed by a 0.5-probability horizontal flip that swaps
    direction-sensitive labels (SSv2 map).  frames: (T, H, W, 3) uint8
    -> ((T, input_size, input_size, 3), label)."""
    t, h, w, _ = frames.shape
    box = sample_multiscale_crop(w, h, (input_size, input_size), rng)
    out = crop_and_resize(frames, box, (input_size, input_size))
    return hflip_with_label(out, label, label_transforms, rng, mode="swap")


SSV2_LABEL_FLIP = {86: 87, 87: 86, 93: 94, 94: 93, 166: 167, 167: 166}


def normalize_clip(frames: np.ndarray, mean: Sequence[float],
                   std: Sequence[float], scale_255: bool = True) -> np.ndarray:
    """uint8 (..., 3) -> float32 normalized.

    TANet: /255 then (x-mean)/std with mean/std in [0,1]
    (ToTorchFormatTensor + GroupNormalize, transforms.py:657-686, 140-152).
    Swin: no /255; mean/std on the 0-255 scale (mmcv imnormalize,
    transforms_backup.py:1120-1202) — pass scale_255=False.
    """
    if frames.dtype == np.uint8:
        return native.normalize(frames, mean, std, div255=scale_255)
    x = frames.astype(np.float32)
    if scale_255:
        x = x / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (x - mean) / std
