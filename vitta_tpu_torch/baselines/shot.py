"""SHOT baseline: source-hypothesis transfer (vitta_tpu/baselines/shot.py;
reference baselines/shot.py and shot_utils.py).

Protocol (shot.py:62-137): the net split into a feature extractor and a
frozen classifier (configure_shot, shot.py:41-59); per epoch (a)
cluster-refined pseudo-labels over the whole stream with the extractor in
eval mode (``ext.eval()``, shot.py:70: running-stat BN, no dropout;
obtain_shot_label, shot_utils.py:7-68: class centroids from
softmax-weighted normalized features with an appended ones column, cosine
cdist, one refinement round), (b) one SGD(lr 5e-5, momentum 0.9) pass
minimizing 0.001*CE(pseudo) + entropy - diversity (shot.py:102-117) with
the extractor in train mode (``ext.train()``, shot.py:73: dropout on,
batch-stat BN with running-stat updates), then an evaluation in eval mode
with the adapted running statistics (validate, basics.py:152).

Each batch's dropout draws from the baseline's ``torch.Generator`` seeded
with ``video_seed(seed, epoch * 100003 + batch)``.  Runs on TANet, whose
``classify`` is the classifier (vitta_tpu's Video Swin has none).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.distance import cdist

from vitta_tpu_torch.adapt.loops import video_seed
from vitta_tpu_torch.baselines.common import BaselineBase, batched_eval_iter

CLS_PAR = 0.001     # args_shot.cls_par
ENT_PAR = 1.0       # args_shot.ent_par
SHOT_LR = 5e-5      # args_shot.lr
N_EPOCH = 1         # args_shot.nepoch


def refine_labels(all_fea: np.ndarray, all_out: np.ndarray) -> np.ndarray:
    """obtain_shot_label's clustering (shot_utils.py:40-68) on the stream's
    clip features (N, F) and softmax outputs (N, K), float32."""
    all_fea = np.concatenate([all_fea, np.ones((len(all_fea), 1),
                                               np.float32)], 1)
    all_fea = all_fea / np.linalg.norm(all_fea, axis=1, keepdims=True)
    k = all_out.shape[1]
    aff = all_out
    initc = aff.T @ all_fea / (1e-8 + aff.sum(0)[:, None])
    pred = cdist(all_fea, initc, "cosine").argmin(1)
    for _ in range(1):  # one refinement round (shot_utils.py:59-65)
        aff = np.eye(k, dtype=np.float32)[pred]
        initc = aff.T @ all_fea / (1e-8 + aff.sum(0)[:, None])
        pred = cdist(all_fea, initc, "cosine").argmin(1)
    return pred.astype(np.int64)


def shot_loss(logits: torch.Tensor, pseudo: torch.Tensor) -> torch.Tensor:
    """0.001 * CE(pseudo) + entropy - diversity of (B, K) logits
    (shot.py:102-117)."""
    log_p = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.gather(log_p, -1, pseudo[:, None]))
    sm = torch.exp(log_p)
    ent = torch.mean(-torch.sum(sm * torch.log(sm + 1e-5), dim=-1))
    msm = torch.mean(sm, dim=0)
    div = torch.sum(-msm * torch.log(msm + 1e-5))
    return CLS_PAR * ce + ENT_PAR * (ent - div)


class ShotBaseline(BaselineBase):
    def __init__(self, model, cfg, state_dict, device="cuda"):
        super().__init__(model, cfg, state_dict, device=device)
        self.generator = torch.Generator(device=self.device)

    def _view_mean(self, t: torch.Tensor) -> np.ndarray:
        e = self.n_eval_views
        return t.reshape(t.shape[0] // e, e, -1).mean(dim=1).cpu().numpy()

    def pseudo_labels(self, dataset, batch_size) -> np.ndarray:
        """obtain_shot_label (shot_utils.py:7-68) with the extractor in
        eval mode."""
        classify = self._classifier()
        feats, outs = [], []
        for clips, _ in batched_eval_iter(dataset, batch_size):
            with torch.no_grad():
                f = self.model.features(self._to_device(clips))  # (B*E, F)
                o = classify(f)
            feats.append(self._view_mean(f))
            outs.append(self._view_mean(o))
        all_out = torch.softmax(torch.from_numpy(np.concatenate(outs, 0)),
                                dim=-1).numpy()
        return refine_labels(np.concatenate(feats, 0), all_out)

    def adapt_step(self, x, pseudo, optimizer) -> torch.Tensor:
        """One train-mode SGD step on the extractor (ext.train(),
        shot.py:73-120): dropout from ``self.generator``, batch-stat BN
        with running-stat updates; the classifier's gradient zeroed
        (configure_shot, shot.py:47-52)."""
        optimizer.zero_grad(set_to_none=True)
        f = self.model.features(x, train=True, generator=self.generator,
                                use_running_average=False,
                                update_running_stats=True)
        loss = shot_loss(self._mean_logits(self.model.classify(f)), pseudo)
        loss.backward()
        for p in self.model.new_fc.parameters():
            p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach()

    def run(self, eval_dataset, batch_size: int = 4, seed: int = 0) -> float:
        self.reset()
        optimizer = torch.optim.SGD(self.model.parameters(), lr=SHOT_LR,
                                    momentum=0.9, dampening=0.0)
        best = 0.0
        for epoch in range(N_EPOCH):
            pseudo = self.pseudo_labels(eval_dataset, batch_size)
            off = 0
            for bi, (clips, labels) in enumerate(
                    batched_eval_iter(eval_dataset, batch_size)):
                pl = self._to_device(pseudo[off:off + labels.shape[0]])
                off += labels.shape[0]
                self.generator.manual_seed(
                    video_seed(seed, epoch * 100003 + bi))
                self.adapt_step(self._to_device(clips), pl, optimizer)
            # model.eval() for the accuracy pass (validate, basics.py:152):
            # running-average BN with the adapted statistics
            best = max(best, self.evaluate(
                lambda x: self.model(x, None, train=False), eval_dataset,
                batch_size))
        return best
