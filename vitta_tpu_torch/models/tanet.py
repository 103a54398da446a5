"""TANet — TSN wrapper around ResNet-50+TAM with average consensus.

The PyTorch counterpart of vitta_tpu/models/tanet.py (reference
models/tanet_models/tanet.py:16-333):

* input ``(B, T, H, W, 3)`` channels-last, as in the JAX package; the
  frames fold into the batch for the 2D backbone (tanet.py:317);
* Dropout(0.8) + ``new_fc`` Linear(2048 -> K) (tanet.py:93-123); the
  dropout mask is drawn from the ``torch.Generator`` the caller passes;
* per-frame logits averaged over T (avg consensus, tanet.py:329-333).

``fix_BNS`` (corpus/basics.py:606-611): norm layers use running
statistics unless the caller asks for the batch-stat form; ``train``
only switches dropout on.

``use_tam=False`` builds the backbone without its TAMs, a plain ResNet-50
of frames (vitta_tpu/models/tanet.py:31): no ``tam.*`` parameters and no
BatchNorm1d taps.

``dtype`` ("float32" or "bfloat16", ``cfg.model.compute_dtype``) is the
backbone's compute dtype (vitta_tpu/models/tanet.py:35); the parameters,
the pooled features, dropout, ``new_fc`` and the logits stay float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vitta_tpu_torch.models.resnet import ResNetTAM


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout drawing its mask from ``generator``: keep where
    uniform < 1 - rate, as flax's Dropout does."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class TANet(nn.Module):
    def __init__(self, num_classes: int, clip_length: int = 16,
                 dropout: float = 0.8, use_tam: bool = True,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 dtype: str = "float32"):
        super().__init__()
        self.num_classes = num_classes
        self.clip_length = clip_length
        self.dropout = dropout
        self.base_model = ResNetTAM(clip_length, tuple(stat_types),
                                    dtype=dtype, use_tam=use_tam)
        self.dtype = self.base_model.dtype
        self.new_fc = nn.Linear(2048, num_classes)

    def _frame_features(self, x, taps, train, generator, use_running_average,
                        update_running_stats):
        """(B*T, 2048) per-frame features, after the TSN dropout when
        ``train``."""
        b, t, h, w, c = x.shape
        if t != self.clip_length:
            raise ValueError(f"clip of {t} frames; the model was built for "
                             f"{self.clip_length}")
        feats = self.base_model(
            x.reshape(b * t, h, w, c), taps,
            use_running_average=use_running_average,
            update_running_stats=update_running_stats)
        if train and self.dropout > 0:
            feats = dropout(feats, self.dropout, generator)
        return feats

    def forward(self, x, taps: Optional[dict] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        """x: (B, T, H, W, 3) -> logits (B, num_classes)."""
        b, t = x.shape[:2]
        feats = self._frame_features(x, taps, train, generator,
                                     use_running_average, update_running_stats)
        logits = self.new_fc(feats).reshape(b, t, self.num_classes)
        return torch.mean(logits, dim=1)

    def features(self, x, *, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 use_running_average: bool = True,
                 update_running_stats: bool = False):
        """Clip-level features (B, 2048): the per-frame features averaged
        over T before the classifier, for SHOT and T3A
        (vitta_tpu/models/tanet.py:62-78).  ``train`` applies the TSN
        dropout to the per-frame features before the mean, as the extractor
        runs during SHOT's adaptation (reference baselines/shot.py:73)."""
        b, t = x.shape[:2]
        feats = self._frame_features(x, None, train, generator,
                                     use_running_average, update_running_stats)
        return feats.reshape(b, t, -1).mean(dim=1)

    def classify(self, feats):
        """The classifier on clip features (SHOT's frozen classifier)."""
        return self.new_fc(feats)
