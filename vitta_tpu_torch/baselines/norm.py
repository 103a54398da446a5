"""NORM baseline: test-time batch normalization
(vitta_tpu/baselines/norm.py; reference baselines/norm.py:4-49 and the
adaptation pre-pass corpus/basics.py:129-143).

BatchNorm layers normalize with the statistics of the test batch, and the
running statistics are updated with momentum 0.1 as the batches pass.
Predictions depend only on the batch statistics.
"""

from __future__ import annotations

from vitta_tpu_torch.baselines.common import BaselineBase


class NormBaseline(BaselineBase):
    def run(self, eval_dataset, batch_size: int = 1) -> float:
        self.reset()
        return self.evaluate(
            lambda x: self.model(x, None, train=False,
                                 use_running_average=False,
                                 update_running_stats=True),
            eval_dataset, batch_size)
