"""Process group utilities for stream-parallel adaptation.

The PyTorch counterpart of vitta_tpu/parallel/mesh.py.  vitta_tpu puts
corruption streams on the ``stream`` axis of a ``jax.sharding.Mesh`` and
every device carries its own stream's state.  The port runs **one process
per stream** instead: each process holds its own ``VittaEngine`` and state
on its own device, and the processes share only host-side metric gathers
and barriers (``parallel/streams.py``).  So ``make_mesh``,
``shard_leading_axis`` and ``replicated`` have no counterpart here: no
tensor is ever split across processes.

The process group uses the **gloo** backend, on the host.  Its collectives
carry a few floats a video (top-1, meters) and the barriers, and gloo runs
any number of ranks on one GPU, where NCCL refuses two ranks on one device
("Duplicate GPU detected"); several streams sharing one card
(``streams_per_chip`` > 1) is the deployment this serves.  Tensors move to
the CPU before a collective.

Launch with ``torchrun --nproc_per_node N -m <entry> ...``, which sets the
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` environment ``initialize_distributed`` reads.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           init_method: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the gloo process group; return its size.

    ``num_processes`` and ``process_id`` default to torchrun's
    ``WORLD_SIZE`` and ``RANK`` (1 and 0 without them).  The rendezvous is
    ``init_method`` where given (a ``file://`` path in the tests, so that
    concurrent test runs never share a port), else
    ``tcp://<coordinator>`` (``host:port``), else torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``).  Every collective of
    the group times out after ``timeout_s``.  A no-op where there is one
    process or the group is already up."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = (int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None
             else int(num_processes))
    if world <= 1:
        return 1
    rank = (int(os.environ.get("RANK", "0")) if process_id is None
            else int(process_id))
    if init_method is None:
        init_method = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return world


def world_size() -> int:
    """Processes in the group; 1 where none is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 where no group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host: torchrun's ``LOCAL_RANK``, else
    the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def coordination_barrier(tag: str, timeout_ms: int = 600_000) -> None:
    """Host barrier of the whole group with a timeout
    (``monitored_barrier``, gloo's), so that a rank that never comes fails
    the others instead of hanging them; the error names ``tag``.  A no-op
    for a single process.  Every call site is reached in the same order on
    every rank, as vitta_tpu's barriers are (vitta_tpu/parallel/mesh.py:
    43-73)."""
    if world_size() <= 1:
        return
    try:
        dist.monitored_barrier(
            timeout=datetime.timedelta(milliseconds=timeout_ms))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} on rank {rank()}: {e}") from e


def stream_device(local_rank: int, streams_per_chip: int) -> torch.device:
    """The device of the stream process of ``local_rank``:
    ``cuda:{local_rank // streams_per_chip}``, made the process's current
    CUDA device, or the CPU where ``VITTA_PLATFORM=cpu``.  Raises where
    there is no card, and where the index is at or past the host's cards
    (2 processes at ``streams_per_chip`` 1 on a one-card machine): it never
    wraps around and never falls back to the CPU."""
    from vitta_tpu_torch.cli.opts import run_device

    if streams_per_chip < 1:
        raise ValueError(f"streams_per_chip={streams_per_chip}: at least 1")
    if run_device().type == "cpu":
        return torch.device("cpu")
    index = local_rank // streams_per_chip
    n = torch.cuda.device_count()
    if index >= n:
        raise RuntimeError(
            f"local rank {local_rank} at {streams_per_chip} streams a card "
            f"needs card {index}; this host has {n}. Launch at most "
            f"{n * streams_per_chip} processes a host, or raise "
            "--streams_per_chip")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


class SpawnedGroup:
    """``n`` spawned processes (never forked: a parent that has touched
    CUDA cannot fork), rank ``r`` running ``target(r, n, *args)``;
    ``target`` is a module-level function, typically one that joins the
    group with ``initialize_distributed(n, r, init_method=...)``.  Build
    the kernels in the parent first, so that the processes do not all run
    ``nvcc`` at once."""

    def __init__(self, target: Callable, n: int, args: Sequence = ()):
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=target, args=(r, n, *args))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def join(self, timeout_s: float, expect: int = 0,
             what: str = "process group") -> None:
        """Wait for every process against one deadline ``timeout_s`` away,
        kill those still running at it, and raise unless every exit code
        is ``expect``."""
        deadline = time.monotonic() + timeout_s
        try:
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
        codes = [p.exitcode for p in self.procs]
        if alive or any(c != expect for c in codes):
            raise RuntimeError(f"{what}: exit codes {codes} (want {expect}),"
                               f" {len(alive)} killed after {timeout_s} s")
