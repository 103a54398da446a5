"""T3A baseline: test-time template adjustment (vitta_tpu/baselines/t3a.py;
reference baselines/t3a.py:29-127).

Keeps a support set initialized from the classifier weight rows; per batch
appends (feature, one-hot pseudo-label, entropy); keeps the ``filter_K``
lowest-entropy supports per class; classifies by
``z @ normalize(supports_normalized^T @ labels)``.  The support set is
managed on the host in numpy, as in vitta_tpu; the features come from the
model on its device.  Runs on TANet, whose ``classify`` is the classifier.
"""

from __future__ import annotations

import numpy as np
import torch

from vitta_tpu_torch.baselines.common import BaselineBase, batched_eval_iter
from vitta_tpu_torch.utils.meters import AverageMeter

DEFAULT_FILTER_K = 100  # args.t3a_filter_k is undeclared in the reference
                        # (t3a.py:52) — it must be injected manually there.


def _entropy(p_logits: np.ndarray) -> np.ndarray:
    x = p_logits - p_logits.max(-1, keepdims=True)
    sm = np.exp(x)
    sm /= sm.sum(-1, keepdims=True)
    return -(sm * np.log(np.clip(sm, 1e-30, None))).sum(-1)


class T3ABaseline(BaselineBase):
    def __init__(self, model, cfg, state_dict, device="cuda",
                 filter_k: int = DEFAULT_FILTER_K):
        super().__init__(model, cfg, state_dict, device=device)
        self.filter_k = filter_k

    def init_supports(self) -> None:
        """The support set from the classifier's weight rows, labelled by
        the classifier's own predictions on them."""
        classify = self._classifier()
        k = self.cfg.model.num_classes
        with torch.no_grad():
            w = self.model.new_fc.weight.detach()     # (K, F) class rows
            warm_logits = classify(w).cpu().numpy()
        self.supports = w.cpu().numpy()
        self.labels = np.eye(k, dtype=np.float32)[warm_logits.argmax(1)]
        self.ents = _entropy(warm_logits)

    def adjust(self, z: np.ndarray, p: np.ndarray) -> np.ndarray:
        """One batch's clip features ``z`` (B, F) and classifier logits
        ``p`` (B, K) into the support set, the ``filter_k`` lowest-entropy
        supports per predicted class kept; returns the batch's predictions
        by the adjusted templates."""
        k = self.cfg.model.num_classes
        s = np.concatenate([self.supports, z], 0)
        l = np.concatenate([self.labels,
                            np.eye(k, dtype=np.float32)[p.argmax(1)]], 0)
        en = np.concatenate([self.ents, _entropy(p)], 0)
        keep = []
        yhat = l.argmax(1)
        for c in range(k):
            idx = np.nonzero(yhat == c)[0]
            order = idx[np.argsort(en[idx])][:self.filter_k]
            keep.append(order)
        keep = np.concatenate(keep)
        self.supports, self.labels, self.ents = s[keep], l[keep], en[keep]

        sn = s[keep] / np.linalg.norm(s[keep], axis=1, keepdims=True)
        weights = sn.T @ l[keep]                              # (F, K)
        weights = weights / np.clip(
            np.linalg.norm(weights, axis=0, keepdims=True), 1e-12, None)
        return (z @ weights).argmax(1)

    def run(self, eval_dataset, batch_size: int = 1) -> float:
        self.reset()
        self.init_supports()
        classify = self._classifier()
        top1 = AverageMeter()
        for clips, y in batched_eval_iter(eval_dataset, batch_size):
            with torch.no_grad():
                z = self.model.features(self._to_device(clips))
                e = self.n_eval_views
                z = z.reshape(z.shape[0] // e, e, -1).mean(dim=1)  # (B, F)
                p = classify(z).cpu().numpy()
            pred = self.adjust(z.cpu().numpy(), p)
            top1.update(100.0 * float((pred == y).mean()), n=y.shape[0])
        return top1.avg
