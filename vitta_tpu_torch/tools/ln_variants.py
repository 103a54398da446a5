"""Time the LayerNorm backward at other shapes of its work, on the card.

    python3 -m vitta_tpu_torch.tools.ln_variants

``csrc/ln_rows.cuh`` and ``csrc/reduce.cuh`` fix the choices of the
LayerNorm backward as constants: the rows a block takes at least
(``kLnBwdMinRows``), the blocks at most (``kLnBwdBlocks``), and, in the
second launch, the number of partials from which a sum is staged in shared
memory (``kStagedCount``) and how many it stages at once (``kStageRows``).
This script copies ``csrc/`` for each entry of ``VARIANTS`` with those
constants changed, builds ``ln.cu`` from each copy with ``nvcc -Xptxas
-v`` and prints the backward kernels' registers and spills.  At every
LayerNorm site of a Swin-B and a Swin-T backward pass of 2 clips
(tools/ln_bias_sites.py) it checks every build against the plain version
(1e-5 of each gradient's largest value); then it times one backward call
of each build at each site, in turns over ``ROUNDS`` rounds (device time
from torch.profiler, both launches), and prints per pass the median, least
and most of the rounds' sums, and the median of each launch.  Needs a CUDA
device and nvcc; the copies and their libraries go to
``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys

import torch

from vitta_tpu_torch.ops import _build, cuda_ln
from vitta_tpu_torch.tools.ln_bias_sites import (SWIN_LN_SITES,
                                                 SWIN_T_LN_SITES)

# name -> constants of csrc/*.cuh changed; the first is the source's own
VARIANTS = {
    "as the source": {},
    "min rows 4": {"kLnBwdMinRows": 4},
    "min rows 16": {"kLnBwdMinRows": 16},
    "blocks 66": {"kLnBwdBlocks": 66},
    "staged from 1024 partials": {"kStagedCount": 1024},
    "stage 64 rows": {"kStageRows": 64},
}
TOL = 1e-5
ROUNDS = 5


def build_variant(tag: int, consts: dict):
    """The variant's library, or None where nvcc refuses it."""
    src_dir = _build.BUILD_DIR / "variants" / f"ln_{tag}"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    shutil.copytree(_build.CSRC_DIR, src_dir)
    for name, value in consts.items():
        hits = 0
        for path in src_dir.glob("*.cuh"):
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", path.read_text())
            path.write_text(text)
            hits += n
        if hits != 1:
            raise SystemExit(f"csrc/ holds no one constant {name}")
    out = src_dir / "libln.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", str(out), str(src_dir / "ln.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"  {consts}: nvcc failed:\n{proc.stderr[-2000:]}", flush=True)
        return None
    lines = proc.stderr.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "ln_bwd_kernelILb1" in line or "reduce_partials" in line):
            name = line.split("'")[1]
            info = " ".join(x.replace("ptxas info    :", "").strip()
                            for x in lines[k + 1:k + 4]
                            if "spill" in x or "registers" in x)
            print(f"  {consts or 'as the source'} {name}: {info}", flush=True)
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.vitta_ln_bwd.argtypes = [p, p, p, p, p, p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
    lib.vitta_ln_bwd.restype = ctypes.c_int
    lib.vitta_ln_bwd_scratch_floats.argtypes = [ctypes.c_longlong,
                                                ctypes.c_int]
    lib.vitta_ln_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


def device_us(fn, reps: int = 10):
    """{kernel: device us a call} of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {("reduce" if "reduce" in e.key else "rows"):
            e.self_device_time_total / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("ln_variants: no CUDA device", file=sys.stderr)
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
    sites = []
    for model, table in (("swin_b", SWIN_LN_SITES),
                         ("swin_t", SWIN_T_LN_SITES)):
        for (tokens, c), n in table.items():
            rows = 2 * tokens
            x = torch.randn(rows, c, device=dev, generator=gen) * 2 + 0.5
            g = torch.randn(c, device=dev, generator=gen)
            dy = torch.randn(rows, c, device=dev, generator=gen)
            sites.append((model, rows, c, n, x, g, dy))
    own = cuda_ln._lib()
    try:
        for name, lib in list(libs.items()):
            cuda_ln._LIB = lib
            for model, rows, c, _n, x, g, dy in sites:
                got = cuda_ln.ln_bwd_cuda(x, g, dy, 1e-5)
                want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
                for a, b in zip(got, want):
                    err = float((a - b).abs().max())
                    if err > TOL * float(b.abs().max()):
                        print(f"{name}: {model} {rows}x{c} outside the "
                              f"tolerance ({err:.2e}); left out", flush=True)
                        libs.pop(name)
                        break
                if name not in libs:
                    break
        sums = {(name, model): [] for name in libs
                for model in ("swin_b", "swin_t")}
        parts = {(name, model, rows, c): []
                 for name in libs for model, rows, c, *_ in sites}
        for _round in range(ROUNDS):
            for name, lib in libs.items():
                cuda_ln._LIB = lib
                total = dict.fromkeys(("swin_b", "swin_t"), 0.0)
                for model, rows, c, n, x, g, dy in sites:
                    us = device_us(lambda: cuda_ln.ln_bwd_cuda(x, g, dy,
                                                               1e-5))
                    total[model] += n * sum(us.values())
                    parts[(name, model, rows, c)].append(us)
                for model, v in total.items():
                    sums[(name, model)].append(v)
    finally:
        cuda_ln._LIB = own
    for name in libs:
        for model in ("swin_b", "swin_t"):
            v = sums[(name, model)]
            print(f"{name}, {model} pass: median {statistics.median(v):.1f} "
                  f"us (min {min(v):.1f}, max {max(v):.1f}) over {ROUNDS} "
                  "rounds", flush=True)
        for model, rows, c, *_ in sites:
            runs = parts[(name, model, rows, c)]
            med = {k: statistics.median(r[k] for r in runs if k in r)
                   for k in ("rows", "reduce")}
            print(f"  {model} {rows}x{c}: " + ", ".join(
                f"{k} {v:.2f} us" for k, v in med.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
