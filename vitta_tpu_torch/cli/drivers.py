"""Corruption-sweep drivers.

The PyTorch counterpart of vitta_tpu/cli/drivers.py, reproducing the
reference entry scripts' protocol (tta_tanet_ucf101.py:31-45): iterate the
corruptions, run ``evaluate`` per corruption (the ``val_vid_list`` path is
a template with a ``{}`` for the corruption name), and append one accuracy
row per corruption to the ``all_result`` file.  ``--resume`` skips the
corruptions recorded in ``<result_dir>/sweep_state.json`` and, with
``--stream_ckpt_every``, resumes the interrupted one mid-stream.

vitta_tpu's stream-parallel sweep (``run_parallel_sweep``, corruption
streams sharded over a device mesh) belongs to the port's multi-GPU
streams, which are not ported yet (ROADMAP.md queue 1 item 13); asking for
it raises rather than running the streams one after another.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

from vitta_tpu_torch.cli.main_eval import evaluate
from vitta_tpu_torch.config import VittaConfig
from vitta_tpu_torch.utils.logging import ResultWriter, get_logger

_NO_PARALLEL = ("stream-parallel sweeps (n_parallel_streams > 1, "
                "streams_per_chip != 1) run on several GPUs, which the port "
                "does not do yet: ROADMAP.md queue 1 item 13")


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


def run_corruption_sweep(cfg: VittaConfig, corruptions: Sequence[str],
                         source_kind: str = "decord", records=None,
                         logger=None, device=None) -> dict:
    """Sequential sweep (the reference protocol) on ``device``, by default
    ``opts.run_device()``."""
    if cfg.runtime.n_parallel_streams > 1 or cfg.runtime.streams_per_chip != 1:
        raise NotImplementedError(_NO_PARALLEL)
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
        ccfg = cfg
        if "{}" in cfg.data.val_vid_list:
            ccfg = cfg.replace(data=dataclasses.replace(
                cfg.data, val_vid_list=cfg.data.val_vid_list.format(corruption)))
        rows, _state = evaluate(ccfg, corruption, source_kind=source_kind,
                                records=records, logger=logger, device=device)
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
    """vitta_tpu's stream-parallel sweep; not ported yet."""
    raise NotImplementedError(_NO_PARALLEL)
