"""Run logging and result files.

A copy of vitta_tpu/utils/logging.py: the port imports nothing of the
JAX package.

Replaces reference utils/utils_.py:92-110 (``path_logger``) and
252-267 (``get_writer_to_all_result``): every run gets a timestamped
log file plus an ``all_result`` file that records the full config dump
followed by one accuracy row per corruption.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time
from typing import Any, IO


def make_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def get_logger(result_dir: str, name: str = "vitta_tpu_torch",
               verbose: bool = True) -> logging.Logger:
    """File + stream logger per run (reference utils/utils_.py:92-110)."""
    logger = logging.getLogger(f"{name}.{result_dir}")
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if result_dir:
        make_dir(result_dir)
        log_time = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(result_dir, f"{log_time}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def _config_dump(cfg: Any) -> str:
    if dataclasses.is_dataclass(cfg):
        return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
    return repr(cfg)


class ResultWriter:
    """Per-corruption result rows prefixed with the config dump
    (reference utils/utils_.py:252-267, drivers tta_tanet_ucf101.py:39-45)."""

    def __init__(self, result_dir: str, cfg: Any = None, prefix: str = ""):
        make_dir(result_dir)
        log_time = time.strftime("%Y%m%d_%H%M%S")
        stem = f"{prefix}_{log_time}_all_result" if prefix else f"{log_time}_all_result"
        self.path = os.path.join(result_dir, stem)
        self._f: IO[str] = open(self.path, "w+")
        if cfg is not None:
            self._f.write(_config_dump(cfg))
            self._f.write("\n#############################\n")
            self._f.write("#############################\n\n\n")

    def write_row(self, values) -> None:
        self._f.write(" ".join(str(round(float(v), 3)) for v in values) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
