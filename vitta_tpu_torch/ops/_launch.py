"""What every kernel wrapper of the port shares: launch counters, the
checks a tensor passes before its pointer goes to a kernel, the one place
where a strided cotangent is copied, the raise on a CUDA error code, the
slots of the kernels' tickets (csrc/tickets.cuh) a stream uses; and the
kernel libraries' own counts of their launches, by kernel."""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict

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
# the backward of the four Video Swin ops; and the Video Swin stages that
# ran in window layout (``VITTA_WINDOW_RESIDENT``)
copy_counters = LaunchCounters("contiguity_copies", "window_resident_stages")


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


def check_tensor(what: str, name: str, ten: torch.Tensor, shape, device,
                 contiguous: bool = True, dtypes=(torch.float32,)):
    """Raise unless ``ten`` is a CUDA tensor of ``shape`` on ``device`` with
    one of ``dtypes`` (by default float32 only), and contiguous unless the
    kernel takes its strides."""
    if ten.device.type != "cuda" or ten.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{ten.device}")
    if ten.dtype not in dtypes:
        takes = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"the {what} kernel takes {takes} only; {name} is "
                        f"{ten.dtype}")
    if tuple(ten.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(ten.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not ten.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_units(c: int, width: int, *tensors) -> int:
    """1 where a kernel may move units of ``width`` channels at once: C %
    width == 0 and every tensor it moves by the unit starts on a boundary
    of the unit's bytes (``width`` elements of its type, at most 16 bytes);
    else 0.  A contiguous view may start one element past such a boundary:
    4 bytes in float32, 2 in bfloat16."""
    return int(c % width == 0 and all(
        t.data_ptr() % min(16, width * t.element_size()) == 0
        for t in tensors))


def float4_units(c: int, *tensors) -> int:
    """1 where a kernel may move 16-byte units of 4 floats: C % 4 == 0 and
    every tensor it reads or writes by the unit starts on a 16-byte
    boundary; else 0 (a contiguous view may start 4 bytes past one)."""
    return vector_units(c, 4, *tensors)


class TicketSlots:
    """The slot of a library's tickets (csrc/tickets.cuh) each (device,
    stream) uses.

    The tickets are the library's own device array (one copy per device),
    zero when it is loaded; a launch draws them per tile of its work and
    leaves every one of them 0 again.  Two streams may run the kernels at
    once, so each (device index, stream handle) gets a slot of its own,
    handed out in the order they are first seen, at most ``most`` (the
    library's count) per device; beyond that a call raises.  The slot is a
    launch argument and the array never moves, so a CUDA graph captures and
    replays it as it is: nothing is allocated or zeroed a call.  Replaying
    one graph on two streams at once would share a slot, as it shares the
    graph's scratch.  ``what`` names the kernels in that error."""

    def __init__(self, what: str):
        self._what = what
        self._lock = threading.Lock()
        self._slots = {}

    def __call__(self, device: torch.device, stream: int, most: int) -> int:
        key = (device.index, stream)
        with self._lock:
            slot = self._slots.get(key)
            if slot is None:
                slot = sum(d == device.index for d, _s in self._slots)
                if slot >= most:
                    raise RuntimeError(
                        f"the {self._what} kernels run on at most {most} "
                        f"streams of a device; {device} has used them")
                self._slots[key] = slot
        return slot


def raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def library_launches() -> Dict[str, int]:
    """{kernel name: launches} made so far in this process by the kernel
    libraries it has loaded (csrc/launches.cuh: every launch site counts
    its own launches), added up over the libraries."""
    from vitta_tpu_torch.ops._build import loaded_libraries
    counts: Dict[str, int] = {}
    for lib in loaded_libraries():
        read = lib.vitta_launch_counts
        read.argtypes = [ctypes.c_char_p, ctypes.c_int]
        read.restype = ctypes.c_int
        need = read(None, 0)
        buf = ctypes.create_string_buffer(need + 1)
        read(buf, need + 1)
        for line in buf.value.decode().splitlines():
            name, n = line.rsplit("\t", 1)
            counts[name] = counts.get(name, 0) + int(n)
    return counts


def launches_of(fn: Callable[[], object]) -> Dict[str, int]:
    """{kernel name: launches} that one call of ``fn`` made, from the
    libraries' own counts: the kernels it launched and how often, whether
    or not a profiler is running."""
    before = library_launches()
    fn()
    after = library_launches()
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}
