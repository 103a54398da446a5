"""Corruption-sweep drivers.

The PyTorch counterpart of vitta_tpu/cli/drivers.py, reproducing the
reference entry scripts' protocol (tta_tanet_ucf101.py:31-45): iterate the
corruptions, run ``evaluate`` per corruption (the ``val_vid_list`` path is
a template with a ``{}`` for the corruption name), and append one accuracy
row per corruption to the ``all_result`` file.  ``--resume`` skips the
corruptions recorded in ``<result_dir>/sweep_state.json`` and, with
``--stream_ckpt_every``, resumes the interrupted one mid-stream.

``run_parallel_sweep`` is vitta_tpu's stream-parallel mode: the pending
corruptions are adapted in groups of up to the world size, one process a
stream (``parallel/streams.py``), launched by torchrun, several processes
on one card where ``--streams_per_chip`` says so:

  torchrun --nproc_per_node 2 -m vitta_tpu_torch.scripts.tta_tanet_ucf101 \\
      --n_parallel_streams 2 --streams_per_chip 2 ...
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Sequence

from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.adapt.stream_ckpt import StreamCheckpointer
from vitta_tpu_torch.cli.main_eval import (evaluate, load_source_stats,
                                           load_variables, make_datasets)
from vitta_tpu_torch.config import VittaConfig
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.parallel.mesh import (coordination_barrier,
                                           initialize_distributed, local_rank,
                                           rank, stream_device)
from vitta_tpu_torch.parallel.streams import run_parallel_streams
from vitta_tpu_torch.utils.logging import ResultWriter, get_logger


def _sweep_state_path(result_dir: str) -> str:
    return os.path.join(result_dir, "sweep_state.json")


def _load_sweep_state(cfg, logger) -> dict:
    """Completed {corruption: rows} from a previous interrupted sweep
    (``--resume``); empty when resume is off or no state exists."""
    if not cfg.runtime.resume:
        return {}
    path = _sweep_state_path(cfg.runtime.result_dir)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        done = json.load(f)
    if done:
        logger.info(f"resume: skipping {len(done)} completed corruptions: "
                    f"{sorted(done)}")
    return done


def _save_sweep_state(result_dir: str, results: dict) -> None:
    """Atomic checkpoint of completed corruption rows."""
    path = _sweep_state_path(result_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({k: [float(v) for v in rows]
                   for k, rows in results.items() if k != "mean"}, f)
    os.replace(tmp, path)


def _corruption_cfg(cfg: VittaConfig, corruption: str) -> VittaConfig:
    """``cfg`` with the ``{}`` of its ``val_vid_list`` made ``corruption``."""
    if "{}" not in cfg.data.val_vid_list:
        return cfg
    return cfg.replace(data=dataclasses.replace(
        cfg.data, val_vid_list=cfg.data.val_vid_list.format(corruption)))


def run_corruption_sweep(cfg: VittaConfig, corruptions: Sequence[str],
                         source_kind: str = "decord", records=None,
                         logger=None, device=None) -> dict:
    """Sequential sweep (the reference protocol) on ``device``, by default
    ``opts.run_device()``."""
    logger = logger or get_logger(cfg.runtime.result_dir,
                                  verbose=cfg.runtime.verbose)
    writer = ResultWriter(cfg.runtime.result_dir, cfg)
    done = _load_sweep_state(cfg, logger)
    results = {}
    for corruption in corruptions:
        if corruption in done:
            # replay the completed row so the all_result file of the
            # resumed run is complete
            results[corruption] = done[corruption]
            writer.write_row(done[corruption])
            continue
        rows, _state = evaluate(_corruption_cfg(cfg, corruption), corruption,
                                source_kind=source_kind, records=records,
                                logger=logger, device=device)
        results[corruption] = rows
        writer.write_row(rows)
        _save_sweep_state(cfg.runtime.result_dir, results)
    writer.close()
    mean_top1 = sum(r[0] for r in results.values()) / max(len(results), 1)
    logger.info(f"mean top-1 over {len(results)} corruptions: {mean_top1:.3f}")
    results["mean"] = [mean_top1]
    return results


def run_parallel_sweep(cfg: VittaConfig, corruptions: Sequence[str],
                       source_kind: str = "decord", records=None,
                       logger=None) -> dict:
    """Stream-parallel sweep (vitta_tpu/cli/drivers.py:90-192): the
    pending corruptions in groups of up to the world size (capped by
    ``n_parallel_streams``), rank ``r`` adapting the group's stream ``r`` on
    its stream device (``stream_device``: card
    ``local_rank // streams_per_chip``, or the CPU where
    ``VITTA_PLATFORM=cpu``).  Joins the process group torchrun describes
    (one process: a group of one).  With ``--stream_ckpt_every`` each group
    checkpoints into ``stream_ckpt_group_<sha1 of its corruptions[:12]>``,
    its manifest the full list; rank 0 alone writes ``sweep_state.json``
    and the result file.  Every rank returns the same rows."""
    world = initialize_distributed()
    primary = rank() == 0
    device = stream_device(local_rank(), cfg.runtime.streams_per_chip)
    logger = logger or get_logger(cfg.runtime.result_dir,
                                  verbose=cfg.runtime.verbose)
    done = _load_sweep_state(cfg, logger)
    pending = [c for c in corruptions if c not in done]
    src_stats = load_source_stats(cfg)
    if src_stats is None and cfg.tta.stat_reg != "BNS":
        raise FileNotFoundError(
            "the parallel sweep runs the ViTTA stream, which needs "
            "precomputed source statistics — run compute_stats first")
    engine = VittaEngine(get_model(cfg),
                         cfg, load_variables(cfg, seed=cfg.runtime.seed),
                         src_stats, device=device)
    group_cap = (min(world, cfg.runtime.n_parallel_streams)
                 if cfg.runtime.n_parallel_streams > 1 else world)
    results = dict(done)
    for g0 in range(0, len(pending), group_cap):
        names = list(pending[g0:g0 + group_cap])
        group = [make_datasets(_corruption_cfg(cfg, c), source_kind, records,
                               seed=cfg.runtime.seed) for c in names]
        ckpt = None
        if cfg.runtime.stream_ckpt_every > 0:
            gkey = hashlib.sha1("|".join(names).encode()).hexdigest()[:12]
            ckpt_dir = os.path.join(cfg.runtime.result_dir,
                                    f"stream_ckpt_group_{gkey}")
            if not cfg.runtime.resume:
                # rank 0 clears; the others wait, so that no manifest check
                # races the removal
                if primary:
                    shutil.rmtree(ckpt_dir, ignore_errors=True)
                coordination_barrier("stream_ckpt_clear")
            ckpt = StreamCheckpointer(ckpt_dir, cfg.runtime.stream_ckpt_every,
                                      manifest={"corruptions": names})
        got, _state = run_parallel_streams(
            engine, group, seed=cfg.runtime.seed, logger=logger,
            checkpointer=ckpt, n_workers=cfg.data.num_workers)
        for corruption, acc in zip(names, got):
            results[corruption] = [float(acc)]
        # every rank holds the same rows (the gather); one writes them
        if primary:
            _save_sweep_state(cfg.runtime.result_dir, results)
    if primary:
        writer = ResultWriter(cfg.runtime.result_dir, cfg)
        for corruption in corruptions:
            writer.write_row(results[corruption])
        writer.close()
    accs = [results[c][0] for c in corruptions]
    results["mean"] = [sum(accs) / len(accs)]
    logger.info(f"mean top-1 over {len(accs)} corruptions: "
                f"{results['mean'][0]:.3f}")
    return results
