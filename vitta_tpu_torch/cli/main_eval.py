"""Evaluation dispatcher — the runtime entry of the port.

The PyTorch counterpart of vitta_tpu/cli/main_eval.py (reference ``eval()``,
corpus/main_eval.py:30-232): build the model, load the checkpoint,
construct the data pipeline for one corruption, then dispatch on the run
mode:

* ``compute_stat='mean_var'`` or ``'cossim'`` -> source-statistic
  precompute (``run_compute_stats``);
* ``tta=True``                 -> the ViTTA stream (online or standard);
* otherwise                    -> one of the baselines.

``evaluate`` returns ``(epoch_result_list, state_or_none)`` like the
reference (basics.py:740-747).  Every entry point runs on ``device``, by
default ``opts.run_device()``: the card, or the CPU where
``VITTA_PLATFORM=cpu``.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional, Tuple

import torch

from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.adapt.loops import tta_stream
from vitta_tpu_torch.adapt.precompute import (compute_cossim_statistics,
                                              compute_source_statistics,
                                              save_source_statistics)
from vitta_tpu_torch.adapt.stream_ckpt import StreamCheckpointer
from vitta_tpu_torch.baselines import setup_baseline
from vitta_tpu_torch.baselines.common import batched_eval_iter
from vitta_tpu_torch.cli.opts import run_device
from vitta_tpu_torch.config import VittaConfig
from vitta_tpu_torch.data.dataset import PairedTTADataset, dataset_cls_for
from vitta_tpu_torch.data.pipeline import Prefetcher
from vitta_tpu_torch.data.video_reader import make_video_source
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import (load_reference_checkpoint,
                                              load_reference_cossim,
                                              load_reference_stats,
                                              save_cossim, tanet_norm_layers)
from vitta_tpu_torch.utils.logging import get_logger
from vitta_tpu_torch.utils.observability import MetricsWriter


def load_variables(cfg: VittaConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The model's state dict: a reference checkpoint
    (``load_reference_checkpoint``: tensors only, DataParallel's
    ``module.`` prefix stripped; reference main_eval.py:51-65), or, with no
    checkpoint path, the weights of ``get_model(cfg)`` built under
    ``torch.manual_seed(seed)`` (synthetic and development runs).  The
    caller loads it with ``load_state_dict(strict=True)``, so a checkpoint
    of another model or class count raises there."""
    if cfg.model.checkpoint_path:
        return load_reference_checkpoint(cfg.model.checkpoint_path)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_model(cfg, attn_route="packed")
    return {k: v.clone() for k, v in model.state_dict().items()}


def load_source_stats(cfg: VittaConfig):
    """The precomputed statistics file pair(s) of the configured stat
    type(s) (reference load_precomputed_statistics, basics.py:749-757; the
    temporal pair serves both temp and temp_v2), or the relation-map
    targets of the cossim regularization (basics.py:908-916).

    Returns ``{name: (mean, var)}`` for one statistic type,
    ``{stat_type: {name: (mean, var)}}`` for several, ``{name: sim_vec or
    None}`` for cossim, or ``None`` where a required file is not given."""
    t = cfg.tta
    depths = cfg.model.depths
    if t.stat_reg == "cossim":
        if not t.temp_cossim_clean_file:
            return None
        return load_reference_cossim(t.temp_cossim_clean_file,
                                     cfg.model.arch, depths=depths)
    pairs = {
        "spatiotemp": (t.spatiotemp_mean_clean_file,
                       t.spatiotemp_var_clean_file),
        "spatial": (t.spatial_mean_clean_file, t.spatial_var_clean_file),
        "temp": (t.temp_mean_clean_file, t.temp_var_clean_file),
        "temp_v2": (t.temp_mean_clean_file, t.temp_var_clean_file),
    }
    out = {}
    for st in (t.stat_type or ("spatiotemp",)):
        mf, vf = pairs[st]
        if not (mf and vf):
            return None
        out[st] = load_reference_stats(
            mf, vf, cfg.model.arch,
            include_bn1d=(cfg.model.arch == "tanet"
                          and st in ("temp", "temp_v2")),
            depths=depths)
    if len(out) == 1:
        return next(iter(out.values()))
    return out


def make_datasets(cfg: VittaConfig, source_kind: str = "decord",
                  records=None, seed: int = 0,
                  emit_uint8: Optional[bool] = None) -> PairedTTADataset:
    """The paired (tta views, eval clip) dataset of one corruption.
    ``emit_uint8`` defaults to the TTA mode: the engine normalizes uint8
    frames on the device, so the stream copies 4x fewer bytes to the card;
    the baselines take frames normalized on the host."""
    source = make_video_source(source_kind, cfg.data.video_data_dir,
                               cfg.data.vid_format)
    if emit_uint8 is None:
        emit_uint8 = bool(cfg.tta.tta)
    if cfg.data.legacy_loader and cfg.tta.tta:
        raise ValueError(
            "legacy_loader has no TTA-view mode (the reference's legacy "
            "get_dataset path, basics.py:1350-1444, predates the TTA "
            "samplers) — it serves baseline/source evaluation only")
    return PairedTTADataset(cfg, source, records, seed=seed,
                            dataset_cls=dataset_cls_for(
                                cfg.model.arch, cfg.data.legacy_loader),
                            emit_uint8=emit_uint8)


def _stream_checkpoint(cfg: VittaConfig, corruption: str, engine, logger):
    """(checkpointer, state, start index, meter state) of the mid-stream
    checkpoint under ``--stream_ckpt_every``: with ``--resume`` the latest
    saved state of this corruption's stream, else a fresh directory."""
    if cfg.runtime.stream_ckpt_every <= 0:
        return None, None, 0, None
    ckpt_dir = os.path.join(cfg.runtime.result_dir,
                            f"stream_ckpt_{corruption or 'run'}")
    if not cfg.runtime.resume:
        # a stale state must not leak into a later --resume
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = StreamCheckpointer(ckpt_dir, cfg.runtime.stream_ckpt_every,
                              manifest={"corruptions": [corruption or "run"]})
    if cfg.runtime.resume:
        got = ckpt.restore(engine.init_state(), generator=engine.generator)
        if got is not None:
            state, start, meter_state = got
            logger.info(f"resume: mid-stream checkpoint at video {start} "
                        f"({corruption})")
            return ckpt, state, start, meter_state
    return ckpt, None, 0, None


def evaluate(cfg: VittaConfig, corruption: str = "",
             source_kind: str = "decord", records=None,
             logger=None, device=None,
             no_vids: Optional[int] = None) -> Tuple[list, Optional[object]]:
    """One corruption's stream or baseline on ``device``; ``no_vids`` is
    DUA's number of adaptation videos (None: 1% of the stream, as the
    reference driver, main_eval.py:203-205)."""
    device = run_device() if device is None else torch.device(device)
    logger = logger or get_logger(cfg.runtime.result_dir,
                                  verbose=cfg.runtime.verbose)
    logger.info(f"=== evaluate corruption={corruption or 'n/a'} "
                f"arch={cfg.model.arch} tta={cfg.tta.tta} "
                f"baseline={cfg.runtime.baseline} device={device}")
    model = get_model(cfg)
    state_dict = load_variables(cfg, seed=cfg.runtime.seed)
    paired = make_datasets(cfg, source_kind, records, seed=cfg.runtime.seed)

    if cfg.tta.tta:
        src_stats = load_source_stats(cfg)
        if src_stats is None and cfg.tta.stat_reg != "BNS":
            raise FileNotFoundError(
                "tta=True needs precomputed source statistics (one "
                "--<stat_type>_{mean,var}_clean_file pair per configured "
                "stat_type, or --temp_cossim_clean_file for "
                "stat_reg='cossim') — run compute_stats first")
        engine = VittaEngine(model, cfg, state_dict, src_stats, device=device)
        ckpt, state0, start, meter_state = _stream_checkpoint(
            cfg, corruption, engine, logger)
        # the JSONL scalar stream in the result dir — the counterpart of
        # the reference's tensorboardX writer (main_eval.py:85)
        mw = MetricsWriter(cfg.runtime.result_dir,
                           name=f"metrics_{corruption or 'run'}")
        try:
            result, state, meters = tta_stream(
                engine, Prefetcher(paired, device=device,
                                   n_workers=cfg.data.num_workers,
                                   start=start),
                seed=cfg.runtime.seed, state=state0, metrics_writer=mw,
                logger=logger, print_freq=cfg.runtime.print_freq,
                checkpointer=ckpt, start_index=start,
                meter_state=meter_state)
        finally:
            mw.close()
        logger.info(f"[{corruption}] ViTTA top1 {result[0]:.3f} "
                    f"(mean step time {meters['batch_time'].avg * 1000:.1f} "
                    "ms)")
        return result, state
    baseline_name = cfg.runtime.baseline
    kw = ({"filter_k": cfg.runtime.t3a_filter_k} if baseline_name == "t3a"
          else {})
    b = setup_baseline(baseline_name, model, cfg, state_dict, device=device,
                       **kw)
    batch_size = max(1, cfg.data.batch_size)
    if baseline_name == "dua":
        # DUA reads a (raw frames, eval) dataset pair and adapts per video
        # on augmented batches (reference main_eval.py:177-207,
        # get_dataset_tanet_dua basics.py:1294-1347)
        raw_ds = dataset_cls_for(cfg.model.arch)(
            cfg, paired.source, paired.eval.records, dataset_type="raw",
            seed=cfg.runtime.seed, emit_uint8=True)
        acc = b.run(raw_ds, paired.eval, batch_size=batch_size,
                    no_vids=no_vids, seed=cfg.runtime.seed)
    else:
        acc = b.run(paired.eval, batch_size=batch_size)
    logger.info(f"[{corruption}] baseline={baseline_name} top1 {acc:.3f}")
    return [acc], None


def run_compute_stats(cfg: VittaConfig, source_kind: str = "decord",
                      records=None, out_dir: Optional[str] = None,
                      logger=None, compute_stat: str = "mean_var",
                      device=None):
    """Source-statistic precompute (reference
    compute_stats/compute_spatiotemp_stats_clean_train_*.py), dispatching on
    ``compute_stat`` like the reference ``eval()``
    (corpus/main_eval.py:87-94): 'mean_var' -> per-layer channel statistics
    (the reference's ``.npy`` pair and a name-keyed npz), 'cossim' ->
    pairwise-similarity relation maps.  Returns the paths written."""
    device = run_device() if device is None else torch.device(device)
    logger = logger or get_logger(cfg.runtime.result_dir)
    stat_type = cfg.tta.stat_type[0] if cfg.tta.stat_type else "spatiotemp"
    model = get_model(cfg)
    model.load_state_dict(load_variables(cfg, seed=cfg.runtime.seed),
                          strict=True)
    source = make_video_source(source_kind, cfg.data.video_data_dir,
                               cfg.data.vid_format)
    ds = dataset_cls_for(cfg.model.arch)(cfg, source, records,
                                         dataset_type="eval")
    if cfg.model.arch == "tanet" and stat_type not in ("temp", "temp_v2"):
        # spatial / spatiotemp statistics exist on the BN2d layers only; the
        # temporal types include BatchNorm1d too (basics.py:231-238)
        bn2d = {n for n, kind in tanet_norm_layers() if kind == "bn2d"}
        tap_filter = lambda n: n in bn2d   # noqa: E731
    else:
        tap_filter = None
    out = out_dir or cfg.runtime.result_dir
    batches = batched_eval_iter(ds, cfg.data.batch_size)
    if compute_stat == "cossim":
        sims = compute_cossim_statistics(
            model, batches, clip_len=cfg.data.clip_length,
            stat_type=stat_type, device=device, tap_filter=tap_filter,
            logger=logger)
        os.makedirs(out, exist_ok=True)
        tag = time.strftime("%Y%m%d_%H%M%S")
        # the reference layout: one object-array entry per norm layer in
        # choose_layers order, None where no relation map exists
        # (basics.py:328-338,397-401)
        path = os.path.join(out, f"list_{stat_type}_relationmap_{tag}.npy")
        save_cossim(path, sims, cfg.model.arch, depths=cfg.model.depths)
        logger.info(f"saved cossim relation maps: {path}")
        return (path,)
    stats = compute_source_statistics(
        model, batches, device=device, tap_filter=tap_filter, logger=logger,
        stat_type=stat_type)
    paths = save_source_statistics(stats, cfg.model.arch, out,
                                   stat_type=stat_type,
                                   depths=cfg.model.depths)
    logger.info(f"saved source stats: {paths}")
    return paths
