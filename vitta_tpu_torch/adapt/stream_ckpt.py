"""Mid-stream TTA state checkpointing.

The PyTorch counterpart of vitta_tpu/adapt/stream_ckpt.py.  The sweep
drivers resume at corruption granularity (cli/drivers.py, sweep_state.json);
for long streams (UCF101-C is ~3.8 k videos per corruption) a preemption
mid-corruption loses the whole stream.  This module saves the carried
``TTAState`` (parameters, BatchNorm buffers, optimizer state, EMA, step),
the engine's generator and the host-side meters every N videos, so a killed
run resumes mid-stream and reproduces the uninterrupted trajectory exactly:
the stream, its per-video dropout seeds (``loops.video_seed``), the meters
and the data pipeline are all functions of the video index; only the
wall-clock ``batch_time`` restarts.

The reference has no equivalent: its adapted model is never saved
(corpus/basics.py:742-745 commented out) and an interrupted run restarts the
corruption from scratch.

Layout under ``directory``:
  step_<n>.pt     ``torch.save`` of the state (the next video index to
                  process is <n>)
  latest.json     commit marker {"next_bi", "path", "meters"}, replaced
                  only after the state file is complete, so a kill during a
                  save leaves the previous checkpoint valid
  manifest.json   identity of the stream this directory belongs to
                  (corruption names); a mismatch on open raises instead of
                  restoring a state adapted on another stream

A stream-parallel group (one process a stream, ``parallel/streams.py``)
shares one directory, as vitta_tpu's multi-process runs do
(vitta_tpu/adapt/stream_ckpt.py:44-64): each rank writes its own stream's
state to ``step_<n>/rank_<r>.pt``, all ranks meet at a barrier, and only
rank 0 then writes the commit marker (whose meters are per-stream vectors)
and the manifest and removes superseded checkpoints; the ranks meet again
before any goes on.  ``restore`` reads the rank's own file; ``clear`` is
rank 0's alone.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vitta_tpu_torch.parallel.mesh import (coordination_barrier, rank,
                                           world_size)


def _is_primary() -> bool:
    """Rank 0 of the group, or the only process."""
    return rank() == 0


def _align_processes(tag: str) -> None:
    """Host barrier of a group's processes around the checkpoint's file
    work (vitta_tpu/adapt/stream_ckpt.py:_align_processes); a no-op for a
    single process."""
    coordination_barrier(tag)


def _write(path: str, payload) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of the tensors in nested dicts and tuples (the EMA's
    ``{name: TapStats}`` or ``{key: {name: CumulativeState}}``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}"))
    return out


def _unflatten_like(template, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``template``'s structure with the tensors of ``flat``, each moved to
    the device of the template's tensor at its path."""
    if isinstance(template, torch.Tensor):
        return flat[prefix].to(template.device)
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}")
                for k, v in template.items()}
    return type(template)(*(_unflatten_like(v, flat, f"{prefix}/{i}")
                            for i, v in enumerate(template)))


class StreamCheckpointer:
    def __init__(self, directory: str, every: int = 50,
                 manifest: Optional[dict] = None):
        self.directory = os.path.abspath(directory)
        self.every = max(1, int(every))
        os.makedirs(self.directory, exist_ok=True)
        if manifest is not None:
            self._check_manifest(manifest)

    @property
    def _latest_path(self) -> str:
        return os.path.join(self.directory, "latest.json")

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def _check_manifest(self, manifest: dict) -> None:
        """Pin the directory to one stream's identity, so that a
        hand-edited or reused directory never resumes a state adapted on
        another stream."""
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                stored = json.load(f)
            if stored != manifest:
                raise RuntimeError(
                    f"stream checkpoint directory {self.directory} belongs "
                    f"to a different stream group: stored manifest "
                    f"{stored!r} != requested {manifest!r}. Use a fresh "
                    f"result_dir or clear the checkpoint.")
        elif _is_primary():
            tmp = self._manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, self._manifest_path)

    def save(self, state, next_bi: int, meters: dict,
             generator: Optional[torch.Generator] = None) -> None:
        """Checkpoint ``state`` (a ``TTAState``; None on an idle rank of a
        group) and ``generator``'s state; ``meters`` is {name: (sum,
        count)}, where ``sum`` is a scalar or, in a group, the per-stream
        vector."""
        group = world_size() > 1
        if group:
            path = os.path.join(self.directory, f"step_{next_bi}")
            os.makedirs(path, exist_ok=True)
            mine = os.path.join(path, f"rank_{rank()}.pt")
        else:
            path = mine = os.path.join(self.directory, f"step_{next_bi}.pt")
        if state is not None:
            _write(mine, {
                "params": {k: p.detach() for k, p in state.params.items()},
                "batch_stats": {k: b.detach()
                                for k, b in state.batch_stats.items()},
                "optimizer": state.optimizer.state_dict(),
                "ema": _flatten(state.ema),
                "step": int(state.step),
                "generator": (None if generator is None
                              else generator.get_state()),
            })
        # every stream's file is complete before the marker names it
        _align_processes("stream_ckpt_save")
        if _is_primary():
            tmp = self._latest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"next_bi": int(next_bi), "path": path,
                           "meters": {k: [np.asarray(s, np.float64).tolist(),
                                          int(c)]
                                      for k, (s, c) in meters.items()}}, f)
            os.replace(tmp, self._latest_path)
            # drop superseded checkpoints
            for name in os.listdir(self.directory):
                old = os.path.join(self.directory, name)
                if name.startswith("step_") and old != path:
                    if os.path.isdir(old):
                        shutil.rmtree(old, ignore_errors=True)
                    else:
                        os.remove(old)
        # no rank starts its next save while rank 0 still removes
        _align_processes("stream_ckpt_commit")

    def restore(self, template, generator: Optional[torch.Generator] = None
                ) -> Optional[Tuple[object, int, dict]]:
        """(state, next_bi, meters) of the latest commit, or None.

        ``template`` is the engine's ``init_state()``: the saved parameters,
        buffers and optimizer state are copied into the live tensors it
        names, and the EMA takes its structure and device.  ``generator``,
        where given, gets the saved generator state back.  In a group each
        rank reads its own stream's file; an idle rank (``template`` None)
        gets ``(None, next_bi, meters)``."""
        try:
            with open(self._latest_path) as f:
                meta = json.load(f)
        except FileNotFoundError:
            return None
        meters = {k: (s if isinstance(s, list) else float(s), int(c))
                  for k, (s, c) in meta["meters"].items()}
        if template is None:
            return None, int(meta["next_bi"]), meters
        path = meta["path"]
        if world_size() > 1:
            path = os.path.join(path, f"rank_{rank()}.pt")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k, p in template.params.items():
                p.copy_(saved["params"][k])
            for k, b in template.batch_stats.items():
                b.copy_(saved["batch_stats"][k])
        template.optimizer.load_state_dict(saved["optimizer"])
        if generator is not None and saved["generator"] is not None:
            generator.set_state(saved["generator"])
        state = type(template)(
            params=template.params, optimizer=template.optimizer,
            ema=_unflatten_like(template.ema, saved["ema"]),
            step=saved["step"], batch_stats=template.batch_stats)
        return state, int(meta["next_bi"]), meters

    def clear(self) -> None:
        """Remove the checkpoint (called when the stream completes, so that
        a later --resume of the sweep does not bring back a stale state);
        rank 0's alone in a group."""
        if _is_primary():
            shutil.rmtree(self.directory, ignore_errors=True)
