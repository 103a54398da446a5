"""Source-only baseline: plain evaluation, no adaptation
(vitta_tpu/baselines/source.py; reference setup_baseline.py:47-52)."""

from __future__ import annotations

from vitta_tpu_torch.baselines.common import BaselineBase


class SourceBaseline(BaselineBase):
    def run(self, eval_dataset, batch_size: int = 1) -> float:
        self.reset()
        return self.evaluate(lambda x: self.model(x, None, train=False),
                             eval_dataset, batch_size)
