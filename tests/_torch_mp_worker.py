"""Worker processes of tests/test_torch_parallel.py: the port's stream
parallelism under a real 2-process gloo group on the CPU, spawned by
``parallel.mesh.SpawnedGroup`` as ``worker(rank, world, store, mode,
*args)``:

    worker(rank, world, store, "streams", setup, out)
    worker(rank, world, store, "sweep", result_dir, out, phase)

The group meets through a ``file://`` store (``<store>``), so concurrent
test runs never share a port.  Both modes run one thread a process, as the
test's in-process references do, so that the per-stream results are
bit-equal.

``streams``: ``run_parallel_streams`` over ``S`` streams of ``N_VIDEOS``
videos in groups of the world size, a tiny TANet (T 2, 24 x 24, 4 classes,
dropout 0, lr 1e-2) whose weights and source statistics the test saved to
``<setup>``; every step's metrics, each group's top-1 row and this rank's
final parameters and EMA go to ``<out>.<rank>.pt``.

``sweep``: ``run_parallel_sweep`` over ``SWEEP_CORRUPTIONS`` (two groups
at world size 2, the second of one stream: rank 1 idles in it) at the
CLI's tiny flags with ``--stream_ckpt_every 1``.  ``phase``:
  plain   the uninterrupted sweep, after ``sharded_validate`` over
          ``EVAL_VIDEOS`` (written to the output too);
  kill    dies (exit 3) right after the first mid-stream checkpoint
          commits, both ranks together, as a preempted job would;
  resume  the same sweep with ``--resume``.
Each rank writes its rows and every step's losses to
``<out>.<phase>.<rank>.json``.
"""

import dataclasses
import json
import os

import numpy as np
import torch

T, HW, K, V = 2, 24, 4, 2
S = 4            # corruption streams of the streams mode
N_VIDEOS = 2
SWEEP_CORRUPTIONS = ["gauss", "contrast", "motion"]
SWEEP_VIDEOS = 3
EVAL_VIDEOS = 5
TIMEOUT_S = 300
LR = 1e-2
LOSSES = ("loss_reg", "loss_consis", "loss_ce")


class ArrayStreamDataset:
    """Stream ``i``'s paired items (uint8 views, uint8 eval clip, label),
    seeded by the stream's index."""

    def __init__(self, i: int):
        rng = np.random.default_rng(100 + i)
        self.views = rng.integers(0, 256, (N_VIDEOS, V, T, HW, HW, 3),
                                  dtype=np.uint8)
        self.clips = rng.integers(0, 256, (N_VIDEOS, 1, T, HW, HW, 3),
                                  dtype=np.uint8)
        self.labels = rng.integers(0, K, (N_VIDEOS, 1)).astype(np.int64)

    def __len__(self):
        return N_VIDEOS

    def __getitem__(self, i):
        return self.views[i], self.clips[i], self.labels[i]


def streams_cfg(preset=None):
    """The streams mode's configuration, of ``preset`` (default the port's
    ``tanet_ucf101_preset``): lr 1e-2, as tests/torch_engine_modes.py
    raises it, so that two steps move the weights far above rounding."""
    if preset is None:
        from vitta_tpu_torch.config import tanet_ucf101_preset as preset
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW),
        model=dataclasses.replace(cfg.model, num_classes=K, dropout=0.0),
        optim=dataclasses.replace(cfg.optim, lr=LR))


def sweep_cfg(result_dir: str, resume: bool):
    from vitta_tpu_torch.cli.opts import get_opts
    argv = ["--clip_length", "2", "--input_size", "32", "--scale_size", "40",
            "--result_dir", result_dir, "--video_source", "synthetic",
            "--stat_reg", "BNS", "--n_parallel_streams", "2",
            "--streams_per_chip", "2", "--stream_ckpt_every", "1"]
    if resume:
        argv.append("--resume")
    _, cfg = get_opts(argv)
    return cfg.replace(model=dataclasses.replace(cfg.model, num_classes=K))


def sweep_records(n: int):
    from vitta_tpu_torch.data.records import VideoRecord
    return [VideoRecord(f"v{i}", 40 + 3 * i, i % K) for i in range(n)]


def _recording(engine_cls, log):
    """Wrap ``engine_cls.adapt_eval_step`` so that every step's metrics
    are appended to ``log``."""
    step = engine_cls.adapt_eval_step

    def recorded(self, *a, **k):
        state, m = step(self, *a, **k)
        log.append({f: float(getattr(m, f)) for f in (*LOSSES, "top1")})
        return state, m

    engine_cls.adapt_eval_step = recorded


def run_streams(setup: str, out: str, rank: int) -> None:
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.parallel.streams import run_parallel_streams
    from vitta_tpu_torch.parallel.mesh import world_size

    saved = torch.load(setup, weights_only=False)
    cfg = streams_cfg()
    engine = VittaEngine(get_model(cfg), cfg, saved["sd"], saved["src"],
                         device="cpu")
    log = []
    _recording(VittaEngine, log)
    world = world_size()
    rows, finals = [], []
    for g0 in range(0, S, world):
        group = [ArrayStreamDataset(i) for i in range(g0, min(S, g0 + world))]
        got, state = run_parallel_streams(engine, group, seed=0)
        rows.append(got)
        finals.append(None if state is None else {
            "params": {k: p.detach().clone() for k, p in state.params.items()},
            "ema": {k: tuple(t.clone() for t in v)
                    for k, v in state.ema.items()}})
    torch.save({"steps": log, "rows": rows, "finals": finals},
               f"{out}.{rank}.pt")


def run_sweep(result_dir: str, out: str, phase: str, rank: int) -> None:
    from vitta_tpu_torch.adapt import stream_ckpt
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.cli.drivers import run_parallel_sweep
    from vitta_tpu_torch.cli.main_eval import load_variables
    from vitta_tpu_torch.data.dataset import TANetVideoDataset
    from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.parallel.data_eval import sharded_validate
    from vitta_tpu_torch.parallel.mesh import coordination_barrier

    cfg = sweep_cfg(result_dir, resume=(phase == "resume"))
    record = {}
    if phase == "plain":
        model = get_model(cfg)
        model.load_state_dict(load_variables(cfg, seed=cfg.runtime.seed))
        ds = TANetVideoDataset(cfg, SyntheticVideoSource(48, 64, 50),
                               sweep_records(EVAL_VIDEOS), dataset_type="eval")
        record["validate"] = sharded_validate(model, ds, cfg, batch_size=2)
    if phase == "kill":
        real_save = stream_ckpt.StreamCheckpointer.save

        def save_then_die(self, *a, **k):
            real_save(self, *a, **k)
            coordination_barrier("test-preempt")
            print(f"worker {rank}: simulated preemption after the first "
                  "checkpoint", flush=True)
            os._exit(3)

        stream_ckpt.StreamCheckpointer.save = save_then_die
    log = []
    _recording(VittaEngine, log)
    record["rows"] = run_parallel_sweep(cfg, SWEEP_CORRUPTIONS,
                                        source_kind="synthetic",
                                        records=sweep_records(SWEEP_VIDEOS))
    if phase == "kill":
        raise AssertionError("the checkpoint hook never fired")
    record["steps"] = log
    with open(f"{out}.{phase}.{rank}.json", "w") as f:
        json.dump(record, f)


def worker(rank: int, world: int, store: str, mode: str, *args: str):
    os.environ["VITTA_PLATFORM"] = "cpu"
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vitta_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(num_processes=world, process_id=rank,
                           init_method=f"file://{store}", timeout_s=TIMEOUT_S)
    try:
        if mode == "streams":
            run_streams(*args, rank)
        else:
            run_sweep(*args, rank)
    finally:
        dist.destroy_process_group()
