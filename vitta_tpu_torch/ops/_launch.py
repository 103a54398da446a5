"""What every kernel wrapper of the port shares: launch counters, the
checks a tensor passes before its pointer goes to a kernel, the one place
where a strided cotangent is copied, and the raise on a CUDA error code."""

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


# copies made only to hand a kernel a contiguous tensor, since ``reset``:
# activations in the Video Swin forward (models/swin.py) and cotangents in
# the backward of the four Video Swin ops
copy_counters = LaunchCounters("contiguity_copies")


def contiguous_counted(x: torch.Tensor) -> torch.Tensor:
    """``x`` if it is contiguous, else a contiguous copy, which is counted."""
    if x.is_contiguous():
        return x
    copy_counters.contiguity_copies += 1
    return x.contiguous()


def grad_wanted(*tensors) -> bool:
    """Whether an ``autograd.Function`` applied to ``tensors`` now would
    record a graph: only then does its forward keep anything for a
    backward.  To be asked before ``apply``: inside ``forward`` grad mode
    is always off, and ``needs_input_grad`` ignores ``torch.no_grad()``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
