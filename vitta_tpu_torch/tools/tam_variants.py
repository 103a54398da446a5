"""Time the TAM backward at other shapes of its work, on the card.

    python3 -m vitta_tpu_torch.tools.tam_variants

``csrc/tam.cu`` fixes the choices of its backward as constants: the frames
whose loads a thread issues together (``kDepth``, 4), the most units of a
position (4 channels, or 1) a block spans (``kMaxUnits``, 16), the blocks
the grid aims at (``kTargetBlocks``, 132) and the blocks an SM must hold,
which caps the registers (``kMinBlocks``, 2).  This script writes a copy
of ``csrc/tam.cu`` for each entry of ``VARIANTS`` with those constants
changed, builds each with ``nvcc -Xptxas -v`` and prints each backward
kernel's registers and spills.  At every ResNet-50 TAM site of the adapt
batch (n=2, t=16) it checks every build against the plain version's
autograd (``GRAD_TOL``) and that two runs give the same bits; then it times
one backward call of each build, in turns over ``ROUNDS`` rounds (device
time from torch.profiler, and CUDA-event time), and prints per site the
median over the rounds and per adapt step (the 16 sites) the median, least
and most of the rounds' sums.  Needs a CUDA device and nvcc; the copies and
their libraries go to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys

import torch

from vitta_tpu_torch.ops import _build
from vitta_tpu_torch.ops.cuda_tam import tam_dynamic_conv_reference

# name -> constants of csrc/tam.cu changed; the first is the source's own
VARIANTS = {
    "as the source": {},
    "wc 32": {"kMaxUnits": 32},
    "wc 8": {"kMaxUnits": 8},
    "target 264": {"kTargetBlocks": 264},
    "depth 2": {"kDepth": 2},
    "depth 8": {"kDepth": 8},
    "minb 3": {"kMinBlocks": 3},
}
# ResNet-50's TAM sites, (H, W, C) -> sites per pass (chip_smoke.TAM_SITES)
SITES = {(56, 56, 64): 3, (56, 56, 128): 1, (28, 28, 128): 3,
         (28, 28, 256): 1, (14, 14, 256): 5, (14, 14, 512): 1,
         (7, 7, 512): 2}
GRAD_TOL = 2e-4
ROUNDS = 5


def patched_source(consts: dict) -> str:
    """csrc/tam.cu with the given ``constexpr int`` constants changed."""
    src = (_build.CSRC_DIR / "tam.cu").read_text()
    for name, value in consts.items():
        src, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise SystemExit(f"tam.cu holds no one constant {name}")
    return src


def build_variant(tag: int, consts: dict):
    """The variant's library, or None where nvcc refuses it."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"tam_{tag}.cu"
    src.write_text(patched_source(consts))
    out = out_dir / f"libtam_{tag}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(_build.CSRC_DIR), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"  {consts}: nvcc failed:\n{proc.stderr[-2000:]}", flush=True)
        return None
    lines = proc.stderr.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "tam_bwd" in line:
            kind = "float4" if "float4" in line else "float"
            name = ("reduce" if "reduce" in line else "kernel") + f"<{kind}>"
            info = " ".join(x.replace("ptxas info    :", "").strip()
                            for x in lines[k + 1:k + 4]
                            if "spill" in x or "registers" in x)
            print(f"  {consts or 'as the source'} {name}: {info}", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vitta_tam_bwd.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.vitta_tam_bwd.restype = i
    lib.vitta_tam_bwd_scratch_floats.argtypes = [i] * 5
    lib.vitta_tam_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


def device_ms(fn, reps: int = 10):
    """(summed device ms per call of everything ``fn`` put on the card; the
    blocks' kernel's share), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    us = sum(e.self_device_time_total for e in events)
    main = sum(e.self_device_time_total for e in events
               if "tam_bwd_kernel" in e.key)
    return us / 1e3 / reps, main / 1e3 / reps


def event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("tam_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    libs = {}
    for tag, (name, consts) in enumerate(VARIANTS.items()):
        lib = build_variant(tag, consts)
        if lib is not None:
            libs[name] = lib
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    # per build, the rounds' sums over the 16 sites: device, event ms
    step = {name: ([0.0] * ROUNDS, [0.0] * ROUNDS) for name in libs}
    for (h, w, c), sites in SITES.items():
        n, t, p = 2, 16, h * w
        vec = int(c % 4 == 0)           # fresh tensors: 16-byte aligned
        x = torch.randn(n, t, h, w, c, device=dev, generator=gen)
        a = torch.sigmoid(torch.randn(n, t, c, device=dev, generator=gen))
        k = torch.softmax(torch.randn(n, c, 3, device=dev, generator=gen), -1)
        g = torch.randn(n, t, h, w, c, device=dev, generator=gen)
        leaves = [v.clone().requires_grad_() for v in (x, a, k)]
        with torch.enable_grad():
            want = torch.autograd.grad(tam_dynamic_conv_reference(*leaves),
                                       leaves, g)
        runs = {}
        for name, lib in libs.items():
            outs = [torch.empty_like(v) for v in (x, a, k)]
            scratch = torch.empty(
                lib.vitta_tam_bwd_scratch_floats(n, t, p, c, vec), device=dev)

            def run(lib=lib, outs=outs, scratch=scratch, name=name):
                code = lib.vitta_tam_bwd(
                    g.data_ptr(), x.data_ptr(), a.data_ptr(), k.data_ptr(),
                    outs[0].data_ptr(), scratch.data_ptr(),
                    outs[1].data_ptr(), outs[2].data_ptr(), n, t, p, c, vec,
                    stream)
                if code != 0:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            run()
            first = [o.clone() for o in outs]
            run()
            torch.cuda.synchronize()
            if not all(torch.equal(o, f) for o, f in zip(outs, first)):
                raise AssertionError(f"{name} {(h, w, c)}: two runs differ")
            for what, o, ref in zip(("dx", "dattn", "dkernel"), outs, want):
                torch.testing.assert_close(o, ref, rtol=GRAD_TOL,
                                           atol=GRAD_TOL, msg=what)
            runs[name] = run
        times = {name: ([], [], []) for name in libs}
        order = list(libs)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                dv, main = device_ms(runs[name])
                times[name][0].append(dv)
                times[name][1].append(event_ms(runs[name]))
                times[name][2].append(main)
        gbytes = 3 * x.numel() * 4 / 1e9
        print(f"tam bwd n={n} t={t} {h}x{w}x{c} ({sites} sites), device ms "
              "[least, most] / event ms (the blocks' kernel's device ms), GB/s "
              "of the device time, medians:", flush=True)
        for name in libs:
            for r in range(ROUNDS):
                step[name][0][r] += sites * times[name][0][r]
                step[name][1][r] += sites * times[name][1][r]
            dv, ev, main = (statistics.median(v) for v in times[name])
            print(f"  {name}: {dv:.4f} [{min(times[name][0]):.4f}, "
                  f"{max(times[name][0]):.4f}] / {ev:.4f} ({main:.4f}), "
                  f"{gbytes / dv * 1e3:.0f}", flush=True)
        del x, a, k, g, leaves, want, runs
    print(f"tam bwd per adapt step (16 sites), device / event ms, median "
          f"[least, most] of {ROUNDS} rounds:", flush=True)
    for name, (dv, ev) in step.items():
        print(f"  {name}: {statistics.median(dv):.4f} [{min(dv):.4f}, "
              f"{max(dv):.4f}] / {statistics.median(ev):.4f} [{min(ev):.4f}, "
              f"{max(ev):.4f}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
