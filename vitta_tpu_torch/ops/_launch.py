"""What every kernel wrapper of the port shares: launch counters, the
checks a tensor passes before its pointer goes to a kernel, and the raise
on a CUDA error code."""

from __future__ import annotations

import torch


class LaunchCounters:
    """Integer counters, all 0 after ``reset``; one attribute per name.
    A wrapper adds one to its counter where it launches its kernel and
    nowhere else."""

    def __init__(self, *names: str):
        self._names = names
        self.reset()

    def reset(self):
        for name in self._names:
            setattr(self, name, 0)


def check_tensor(what: str, name: str, ten: torch.Tensor, shape, device):
    """Raise unless ``ten`` is a contiguous float32 CUDA tensor of
    ``shape`` on ``device``."""
    if ten.device.type != "cuda" or ten.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{ten.device}")
    if ten.dtype != torch.float32:
        raise TypeError(f"the {what} kernel takes float32 only; {name} is "
                        f"{ten.dtype}")
    if tuple(ten.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(ten.shape)}, expected "
                         f"{tuple(shape)}")
    if not ten.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def backward_not_ported(what: str, row: int):
    """The error of a forward-only kernel's ``backward`` on the card."""
    raise NotImplementedError(
        f"the backward of the {what} kernel is not ported yet (row {row} of "
        "the kernel table in PERF.md); on a CUDA tensor there is no "
        "fallback to the plain version")
