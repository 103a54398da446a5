"""DUA baseline: no-gradient BatchNorm-statistic adaptation
(vitta_tpu/baselines/dua.py; reference baselines/dua.py and dua_utils.py,
driven from corpus/main_eval.py:182-210).

Per video: a batch of ``DUA_BATCH`` augmented variants (multi-scale crop,
random horizontal flip, random 0/90/180/270 rotation; rotate_batch
dua_utils.py:31-35), one forward without gradients whose BatchNorm layers
update their running statistics, then an evaluation of the whole test set;
stop after ``no_vids`` videos (1% of the stream, main_eval.py:203-205).
The augmentations are the port's data/transforms.py, drawn from a numpy
``default_rng(seed)`` in vitta_tpu's order, so the batches are vitta_tpu's
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vitta_tpu_torch.baselines.common import BaselineBase
from vitta_tpu_torch.data import transforms

DUA_BATCH = 16


class DuaBaseline(BaselineBase):
    @staticmethod
    def _rotate(clip: np.ndarray, k: int) -> np.ndarray:
        """0/90/180/270-degree rotation of (T, H, W, C) frames."""
        return np.rot90(clip, k=k, axes=(1, 2)).copy()

    def augment_batch(self, clip: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        """One video -> (DUA_BATCH, T, S, S, 3) uint8: per variant one
        shared random multi-scale crop to the network input size, a random
        horizontal flip (get_augmentation, utils_.py:151-157:
        GroupMultiScaleCrop + GroupRandomHorizontalFlip) and a random
        0/90/180/270 rotation (rotate_batch, dua_utils.py:31-35)."""
        t, h, w, _ = clip.shape
        size = self.cfg.data.network_input_size
        clip_u8 = (clip if clip.dtype == np.uint8 else
                   np.clip(clip, 0, 255).astype(np.uint8))
        out = []
        for _ in range(DUA_BATCH):
            box = transforms.sample_multiscale_crop(w, h, (size, size), rng)
            var = transforms.crop_and_resize(clip_u8, box, (size, size))
            if rng.random() < 0.5:
                var = var[:, :, ::-1]
            out.append(self._rotate(np.ascontiguousarray(var),
                                    int(rng.integers(0, 4))))
        return np.stack(out)

    def update_stats(self, batch: np.ndarray) -> None:
        """The BatchNorm running statistics updated from one normalized
        augmented batch; the logits are not read."""
        with torch.no_grad():
            self.model(self._to_device(batch), None, train=False,
                       use_running_average=False, update_running_stats=True)

    def run(self, adapt_dataset_raw, eval_dataset, batch_size: int = 1,
            no_vids: int | None = None, seed: int = 0,
            mean=None, std=None) -> float:
        """``adapt_dataset_raw`` yields per-video raw decoded uint8 frames
        (F, H, W, 3) before crop and normalization (the second dataset of
        the reference's DUA pair, basics.py:1330-1347); ``eval_dataset`` is
        the standard eval dataset.  Stops after ``no_vids`` videos, 1% of
        the stream like the reference driver (main_eval.py:203-205,
        ``i == no_vids``); the reference's 3-consecutive-degradation early
        stop (dua.py:85-88) compares the newest accuracy against a window
        that includes itself and therefore never fires, and is not
        replicated (as in vitta_tpu).  Returns the best accuracy seen
        (dua.py:92-95)."""
        self.reset()
        cfg = self.cfg
        mean = mean if mean is not None else cfg.data.input_mean
        std = std if std is not None else cfg.data.input_std
        rng = np.random.default_rng(seed)
        if no_vids is None:
            no_vids = int(len(adapt_dataset_raw) * 1 / 100)
        all_acc = []
        for i in range(len(adapt_dataset_raw)):
            clip = adapt_dataset_raw[i]
            clip = clip.frames if hasattr(clip, "frames") else clip
            batch = self.augment_batch(np.asarray(clip), rng)
            self.update_stats(transforms.normalize_clip(
                batch, mean, std, scale_255=cfg.model.arch == "tanet"))
            all_acc.append(self.evaluate(
                lambda x: self.model(x, None, train=False), eval_dataset,
                batch_size))
            if i == no_vids:
                break
        return max(all_acc)
