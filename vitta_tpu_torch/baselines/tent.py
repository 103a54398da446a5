"""TENT baseline: entropy minimization over the norm layers' affine
parameters (vitta_tpu/baselines/tent.py; reference baselines/tent.py,
hyperparameters hard-coded in setup_baseline.py:9-14: Adam lr 1e-5, beta
0.9, no weight decay, one step a batch).

BatchNorm layers normalize with batch statistics and update their running
statistics (configure_model sets BN train mode, tent.py:61-71); only the
norm layers' weight and bias are updated (collect_params, tent.py:29-45;
``adapt/optim.py:norm_affine_mask``); the loss is the mean softmax entropy
of the view-averaged batch outputs (forward_and_adapt, tent.py:12-26).  The
reference runs one adaptation pass over the loader inside validate
(basics.py:116-128) and then evaluates; ``run`` does the same.

``torch.optim.Adam`` computes optax.adam's update: bias-corrected moments,
eps (1e-8) added outside the square root of the second one.
"""

from __future__ import annotations

import torch

from vitta_tpu_torch.adapt.optim import norm_affine_mask
from vitta_tpu_torch.baselines.common import BaselineBase, batched_eval_iter
from vitta_tpu_torch.ops.losses import softmax_entropy

TENT_LR = 1e-5
TENT_BETA = 0.9


class TentBaseline(BaselineBase):
    def _optimizer(self):
        """(the norm layers' weight and bias, Adam over them)."""
        named = list(self.model.named_parameters())
        mask = norm_affine_mask(named)
        params = [p for name, p in named if mask[name]]
        return params, torch.optim.Adam(params, lr=TENT_LR,
                                        betas=(TENT_BETA, 0.999), eps=1e-8)

    def _loss(self, x):
        """Mean entropy of the view-averaged logits; the forward updates the
        BatchNorm running statistics."""
        logits = self.model(x, None, train=False, use_running_average=False,
                            update_running_stats=True)
        return torch.mean(softmax_entropy(self._mean_logits(logits)))

    def adapt_step(self, x, params, optimizer) -> torch.Tensor:
        """One Adam step on ``x``; the gradients stay in ``p.grad``."""
        optimizer.zero_grad(set_to_none=True)
        loss = self._loss(x)
        loss.backward(inputs=params)
        optimizer.step()
        return loss.detach()

    def run(self, eval_dataset, batch_size: int = 1) -> float:
        self.reset()
        params, optimizer = self._optimizer()
        # adaptation pass over the stream (basics.py:116-128)
        for clips, _labels in batched_eval_iter(eval_dataset, batch_size):
            self.adapt_step(self._to_device(clips), params, optimizer)
        # evaluation with the adapted model, BatchNorm still on batch
        # statistics
        return self.evaluate(
            lambda x: self.model(x, None, train=False,
                                 use_running_average=False),
            eval_dataset, batch_size)
