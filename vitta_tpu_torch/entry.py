"""The port's entry points: one forward step to check, and a multi-process
dry run of the stream-parallel adaptation step.

The counterpart of the repository's ``__graft_entry__.py`` for vitta_tpu.
Both run on the card unless ``VITTA_PLATFORM=cpu`` (``cli/opts.py:
run_device``), and raise where there is none:

    python -m vitta_tpu_torch.entry [n_processes]
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 600


def entry():
    """``(fn, example_args)``: TANet's forward (T 8, 112 x 112, 101
    classes, 2 clips) as ``fn(state, x)`` over the model's parameters and
    buffers ``state``, on the run device, with seeded weights."""
    from vitta_tpu_torch.cli.opts import run_device
    from vitta_tpu_torch.models.tanet import TANet

    device = run_device()
    t, hw, k, v = 8, 112, 101, 2
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TANet(num_classes=k, clip_length=t)
    model = model.to(device)
    state = {k_: t_.detach() for k_, t_ in
             [*model.named_parameters(), *model.named_buffers()]}
    x = torch.zeros((v, t, hw, hw, 3), device=device)

    def forward(state, x):
        with torch.no_grad():
            return torch.func.functional_call(model, state, (x, None),
                                              {"train": False})

    return forward, (state, x)


def _dryrun_worker(rank: int, n: int, streams_per_chip: int, store: str,
                   out: str) -> None:
    """One process of ``dryrun_multichip``: a tiny TANet stream's
    adapt+eval step on its device, the group's losses gathered; rank 0
    writes them to ``out``."""
    import torch.distributed as dist

    from vitta_tpu_torch.parallel.mesh import (initialize_distributed,
                                               stream_device)
    from vitta_tpu_torch.parallel.streams import (StreamParallelEngine,
                                                  stream_video_seed)
    from vitta_tpu_torch.tools.tanet_breakdown import tanet_cfg, tanet_engine

    torch.set_num_threads(1)
    t, hw = 2, 32
    initialize_distributed(num_processes=n, process_id=rank,
                           init_method=f"file://{store}",
                           timeout_s=DRYRUN_TIMEOUT_S)
    try:
        device = stream_device(rank, streams_per_chip)
        engine, _rng = tanet_engine(tanet_cfg(t, 5), seed=0, hw=hw,
                                    device=device)
        spe = StreamParallelEngine(engine, n)
        rng = np.random.default_rng(rank)
        views = rng.integers(0, 256, (2, t, hw, hw, 3), dtype=np.uint8)
        clip = rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8)
        engine.generator.manual_seed(stream_video_seed(1, rank, 1, 0))
        _state, m = spe.adapt_eval_step(spe.init_state(), views, clip,
                                        np.zeros(1, np.int64))
        losses = spe.gather_metrics(m.loss_reg)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(losses.tolist(), f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_processes: int, timeout_s: float = DRYRUN_TIMEOUT_S
                     ) -> list:
    """One stream-parallel adapt+eval step over ``n_processes`` processes,
    a tiny TANet stream each (T 2, 32 x 32, 5 classes), on the CPU where
    ``VITTA_PLATFORM=cpu``, else on the host's cards at
    ``ceil(n / cards)`` streams a card.  The kernels are built here, once,
    before the workers start (spawned, never forked).  Raises unless there
    are ``n`` finite losses; returns them."""
    from vitta_tpu_torch.cli.opts import run_device
    from vitta_tpu_torch.parallel.mesh import SpawnedGroup

    device = run_device()
    spc = 1
    if device.type == "cuda":
        from vitta_tpu_torch.ops import _build
        _build.build_all()
        spc = math.ceil(n_processes / torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as d:
        store, out = os.path.join(d, "store"), os.path.join(d, "losses.json")
        SpawnedGroup(_dryrun_worker, n_processes, (spc, store, out)).join(
            timeout_s, what=f"dryrun_multichip({n_processes})")
        with open(out) as f:
            losses = json.load(f)
    if len(losses) != n_processes or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"dryrun_multichip({n_processes}): losses "
                           f"{losses}")
    print(f"dryrun_multichip OK on {n_processes} processes ({device.type}, "
          f"{spc} a device): loss_reg={losses}", flush=True)
    return losses


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK", tuple(fn(*args).shape), flush=True)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
