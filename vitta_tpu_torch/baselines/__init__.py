"""Baseline TTA methods (vitta_tpu/baselines; reference baselines/,
dispatched by setup_baseline.py:17-44): source / NORM / TENT / SHOT / DUA /
T3A.

Each baseline is a small class around the live model with a
``run(dataset)`` host loop returning top-1.  The behaviours that the
reference sets through module modes (``.train()``, ``requires_grad_``) are
the model's explicit arguments and the optimizer's parameter list:

* BN batch-stat normalization  == ``use_running_average=False``;
* BN running-stat updates      == ``update_running_stats=True``;
* parameter freezing           == parameters left out of the optimizer.
"""

from vitta_tpu_torch.baselines.source import SourceBaseline  # noqa: F401
from vitta_tpu_torch.baselines.norm import NormBaseline  # noqa: F401
from vitta_tpu_torch.baselines.tent import TentBaseline  # noqa: F401
from vitta_tpu_torch.baselines.shot import ShotBaseline  # noqa: F401
from vitta_tpu_torch.baselines.dua import DuaBaseline  # noqa: F401
from vitta_tpu_torch.baselines.t3a import T3ABaseline  # noqa: F401

BASELINES = {
    "source": SourceBaseline,
    "norm": NormBaseline,
    "tent": TentBaseline,
    "shot": ShotBaseline,
    "dua": DuaBaseline,
    "t3a": T3ABaseline,
}


def setup_baseline(name: str, model, cfg, state_dict, device="cuda", **kw):
    """Dispatch (reference setup_baseline.py:17-44); ``device`` is the
    card unless the CPU is asked for."""
    return BASELINES[name](model, cfg, state_dict, device=device, **kw)
