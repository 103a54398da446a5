"""Time the BatchNorm-statistics kernels at other shapes of their work, and
in turns with another checkout's, on the card.

    python3 -m vitta_tpu_torch.tools.bn_variants [--parent DIR ...] [rounds]

``csrc/bn_stats.cu`` fixes the choices of its plan and its loops as
constants: the rows whose loads a thread issues together (``kBnDepthFwd``
4, ``kBnDepthFwd8`` 2 at bfloat16, ``kBnDepthBwd`` 2), the blocks an SM
holds (``kBnBlocksPerSm``, 2: the grid's cap and the kernels'
``__launch_bounds__``), the fewest rows a block takes (``kBnMinChunk``,
32), the most blocks of a cluster (``kBnMaxCluster``, 8) and the partials
the last block loads at once (``kBnSumAhead``, 8).  This script writes a
copy of ``csrc/bn_stats.cu`` for each entry of ``VARIANTS`` with those
constants changed, one more with timestamps (``TRACE_EDITS``) and, with
``--parent``, takes each ``DIR``'s own ``vitta_tpu_torch/csrc/bn_stats.cu``
(an unpacked ``git archive`` of another commit under ``build/``; the
two-launch interface of the commits before this design is bound as it
stands).  It builds them all at once with ``nvcc -Xptxas -v``, prints each
kernel instance's registers and spills and the clusters of 8 blocks the
card holds of each instance of the source.  At every BatchNorm2d site of a
TANet ``mean_var`` step (``BN_SITES``, 29 layers), at float32 and at
bfloat16 (``relu=False``, as ``BatchNorm`` calls it), it checks every
build against the plain versions (y and dx within one bfloat16 ulp at
bfloat16 and ``FWD_TOL`` at float32, m ``FWD_TOL``, v rtol 1e-4 / atol
1e-5, dscale and dbias ``BWD_TOL`` of their largest value) and that two
runs give the same bits; prints the trace build's timeline of one call
(``TRACE_MARKS``: least, median and most over the blocks, in us from the
first block's start, and the SM clock from the blocks' clock64); then it
times one forward and one backward call of each build, in turns over the
rounds: device ms from torch.profiler (every kernel of the call),
CUDA-event ms of eager calls back to back (the host's launches included)
and ms a call of a CUDA graph's replay (the kernels back to back, the gaps
between them included).  The calls repeat on the same tensors, so x (1.6
to 25.7 MB) is read warm from the 50 MB L2 where it fits.  It prints per
site the medians beside the bound (bytes over 3.35 TB/s) and per adapt
pass (29 sites) the median, least and most of the rounds' sums.  Needs a
CUDA device and nvcc; the copies and their libraries go to
``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from vitta_tpu_torch.ops import _build, cuda_stats
from vitta_tpu_torch.ops.cuda_stats import (
    fused_bn_relu_stats_backward_reference, fused_bn_relu_stats_reference)

# name -> constants of csrc/bn_stats.cu changed; the first is the source's
VARIANTS = {
    "as the source": {},
    "bf16 fwd depth 4": {"kBnDepthFwd8": 4},
    "bwd depth 4": {"kBnDepthBwd": 4},
    "min chunk 64": {"kBnMinChunk": 64},
    "clusters of 4": {"kBnMaxCluster": 4},
    "sum ahead 16": {"kBnSumAhead": 16},
}
# every BatchNorm2d of layer3 and layer4 on the adapt batch of 2 x 16 frames
# at 224 x 224, the layers a TANet mean_var step reads: (rows, C) -> sites
BN_SITES = {(25088, 256): 1, (6272, 256): 11, (6272, 1024): 7,
            (6272, 512): 1, (1568, 512): 5, (1568, 2048): 4}
FWD_TOL, BWD_TOL = 1e-5, 2e-5
HBM_BYTES_PER_S = 3.35e12
ROUNDS = 5


def patched_source(consts: dict) -> str:
    """csrc/bn_stats.cu with the given ``constexpr int`` constants changed."""
    src = (_build.CSRC_DIR / "bn_stats.cu").read_text()
    for name, value in consts.items():
        src, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise SystemExit(f"bn_stats.cu holds no one constant {name}")
    return src


def ptxas_lines(stderr: str):
    """"instance: registers, spills" for each kernel ptxas reports."""
    lines = stderr.splitlines()
    for k, line in enumerate(lines):
        found = re.search(r"Compiling entry function '_ZN5vitta(\d+)(\w+)'",
                          line)
        if not found:
            continue
        name = found.group(2)[:int(found.group(1))]
        args = re.search(r"ILi(\d+)ELb(\d)E(13__nv_bfloat16|f)?", line)
        inst = (f"<{args.group(1)}, {'true' if args.group(2) == '1' else 'false'}"
                f"{', bf16' if args.group(3) and 'bfloat16' in args.group(3) else ''}>"
                if args else "")
        info = " ".join(x.replace("ptxas info    :", "").strip()
                        for x in lines[k + 1:k + 4]
                        if "spill" in x or "registers" in x)
        yield f"{name}{inst}: {info}"


# The trace build: the source with a timestamp (%globaltimer, ns) taken by
# each block's first thread at seven points, into a device array read back
# by vitta_bn_trace: 0 the block starts, 1 its rows are done, 2 its warps'
# sums are added, 3 (rank 0) the cluster's sums have landed, 4 its partial
# is written, 5 it drew the tile's last ticket, 7 it added the tile's
# partials, 6 it wrote the tile's sums.
TRACE_MARKS = ("start", "rows done", "block summed", "cluster summed",
               "partial out", "last ticket", "sums out", "tail summed")
TRACE_HEAD = """
__device__ unsigned long long g_bn_trace[1 << 16];
__device__ long long g_bn_clock[1 << 16];
__device__ __forceinline__ void bn_mark(int k) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const unsigned long long at =
        ((unsigned long long)blockIdx.y * gridDim.x + blockIdx.x) * 8 + k;
    g_bn_trace[at] = t;
    g_bn_clock[at] = clock64();
  }
}
"""
TRACE_TAIL = """
extern "C" int vitta_bn_trace(unsigned long long* host, int n, int clear,
                              int clocks) {
  void* at = nullptr;
  cudaError_t e = clocks ? cudaGetSymbolAddress(&at, g_bn_clock)
                         : cudaGetSymbolAddress(&at, g_bn_trace);
  if (e == cudaSuccess && n > 0)
    e = cudaMemcpy(host, at, n * sizeof(unsigned long long),
                   cudaMemcpyDeviceToHost);
  if (e == cudaSuccess && clear)
    e = cudaMemset(at, 0, sizeof(unsigned long long) << 16);
  return (int)e;
}
"""
TRACE_EDITS = (
    ('#include "launches.cuh"\n', TRACE_HEAD, "after"),
    ("  bn_start(sh, csize);\n", "  bn_mark(0);\n", "after"),
    ("  bn_sums<V, true>(sh", "  bn_mark(1);\n", "before"),
    ("  bn_sums<V, false>(sh", "  bn_mark(1);\n", "before"),
    ("  if (csize > 1) {\n    const unsigned rank", "  bn_mark(2);\n",
     "before"),
    ("    __syncthreads();                 // rank 0's own sums too",
     "    bn_mark(3);\n", "before"),
    ("  if (t == 0) {                      // releases", "  bn_mark(4);\n",
     "before"),
    ("  if (!sh.last) return;\n", "  bn_mark(5);\n", "after"),
    ("  if (t == 0) tickets[blockIdx.y] = 0u;", "  bn_mark(6);\n", "before"),
    ("    if (STATS) {\n      const float m", "    bn_mark(7);\n", "before"),
)


def traced_source(consts: dict) -> str:
    """patched_source(consts) with the trace's marks."""
    src = patched_source(consts)
    for anchor, text, where in TRACE_EDITS:
        if anchor not in src:
            raise SystemExit(f"bn_stats.cu: no {anchor!r} to trace at")
        src = src.replace(anchor, anchor + text if where == "after"
                          else text + anchor)
    return src + TRACE_TAIL


def print_trace(lib, call, label):
    """Run ``call`` once more after a warm one and print, per mark, the
    least, median and most time of the blocks that reached it, in us from
    the first block's start."""
    import numpy as np
    read = lib.vitta_bn_trace
    read.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    read.restype = ctypes.c_int
    call()
    torch.cuda.synchronize()
    if read(None, 0, 1, 0) != 0 or read(None, 0, 1, 1) != 0:
        raise RuntimeError("vitta_bn_trace failed")
    call()
    torch.cuda.synchronize()
    buf = np.zeros(1 << 16, dtype=np.uint64)
    clk = np.zeros(1 << 16, dtype=np.int64)
    if (read(buf.ctypes.data, 1 << 16, 1, 0) != 0
            or read(clk.ctypes.data, 1 << 16, 1, 1) != 0):
        raise RuntimeError("vitta_bn_trace failed")
    marks = buf.reshape(-1, 8).astype(np.int64)
    clk = clk.reshape(-1, 8)[marks[:, 0] > 0]
    marks = marks[marks[:, 0] > 0]
    # the SM clock, from the blocks' first and second marks
    rate = np.median((clk[:, 1] - clk[:, 0])
                     / np.maximum(marks[:, 1] - marks[:, 0], 1))
    t0 = marks[:, 0].min()
    parts = []
    for k, name in enumerate(TRACE_MARKS):
        at = marks[:, k][marks[:, k] > 0] - t0
        if len(at):
            parts.append(f"{name} {at.min() / 1e3:.2f}/{np.median(at) / 1e3:.2f}"
                         f"/{at.max() / 1e3:.2f}")
    print(f"  trace {label} ({len(marks)} blocks; us least/median/most; SM "
          f"clock {rate:.2f} GHz): " + ", ".join(parts), flush=True)


def build(name: str, src: Path, include: Path, out: Path):
    """(name, library or None, ptxas's lines) of one build."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(include), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        return name, None, [f"nvcc failed:\n{proc.stderr[-2000:]}"]
    return name, ctypes.CDLL(str(out)), list(ptxas_lines(proc.stderr))


class Build:
    """One library's forward and backward on fixed tensors, by its own C
    interface: with a slot of tickets (this checkout's) or without (the
    two-launch one of the commits before)."""

    def __init__(self, name, lib):
        self.name = name
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        self.slotted = hasattr(lib, "vitta_bn_stats_slots")
        if self.slotted:
            cuda_stats.bind(lib)
        else:
            lib.vitta_bn_stats_scratch_floats.argtypes = [ll, i]
            lib.vitta_bn_stats_scratch_floats.restype = ll
            for d, ptrs in (("fwd", 8), ("bwd", 12)):
                for entry in (f"vitta_bn_stats_{d}", f"vitta_bn_stats_{d}_bf16"):
                    getattr(lib, entry).argtypes = [p] * ptrs + [ll, i, f, i, p]
                    getattr(lib, entry).restype = i
        self.lib = lib

    def calls(self, x, scale, bias, mean, var, m, g_y, g_m, g_v):
        """(forward, backward): each a function of no argument that runs
        one call into outputs made here; and the outputs."""
        rows, c = x.shape
        lib, dev = self.lib, x.device
        y, dx = torch.empty_like(x), torch.empty_like(x)
        stats = torch.empty(2, c, device=dev)
        dsb = torch.empty(2, c, device=dev)
        sfx = "" if x.dtype == torch.float32 else "_bf16"
        floats = (lib.vitta_bn_stats_scratch_floats(rows, c, int(bool(sfx)))
                  if self.slotted
                  else lib.vitta_bn_stats_scratch_floats(rows, c))
        scratch = [torch.empty(floats, device=dev) for _ in range(2)]
        fwd_entry = getattr(lib, f"vitta_bn_stats_fwd{sfx}")
        bwd_entry = getattr(lib, f"vitta_bn_stats_bwd{sfx}")
        slot = (0,) if self.slotted else ()
        ptr = lambda *ts: [t.data_ptr() for t in ts]

        def check(code):
            if code != 0:
                raise RuntimeError(f"{self.name}: CUDA error {code}")

        def fwd():
            check(fwd_entry(*ptr(x, scale, bias, mean, var, y, stats,
                                 scratch[0]), rows, c, 1e-5, 0, *slot,
                            torch.cuda.current_stream().cuda_stream))

        def bwd():
            check(bwd_entry(*ptr(x, scale, bias, mean, var, m, g_y, g_m, g_v,
                                 dx, dsb, scratch[1]), rows, c, 1e-5, 0,
                            *slot, torch.cuda.current_stream().cuda_stream))
        return fwd, bwd, (y, stats, dx, dsb)


def device_ms(fn, reps: int = 10) -> float:
    """Summed device ms per call of every kernel ``fn`` launched, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / reps


def event_ms(fn, reps: int = 20) -> float:
    """CUDA-event ms per call of ``fn`` run back to back, eagerly."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """ms per call of a CUDA graph of ``calls`` calls of ``fn`` (median of
    ``reps`` replays): the kernels back to back, no host between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def check_build(name, outs, x, scale, bias, mean, var, m, g_y, g_m, g_v):
    """Raise unless one build's outputs are the plain versions' within the
    tolerances of the module docstring."""
    from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
    y, stats, dx, dsb = outs
    want_y, (want_m, want_v) = fused_bn_relu_stats_reference(
        x, scale, bias, mean, var, relu=False)
    want = fused_bn_relu_stats_backward_reference(
        x, scale, bias, mean, var, m, g_y, g_m, g_v, relu=False)
    for what, got, ref in (("y", y, want_y), ("dx", dx, want[0])):
        if x.dtype == torch.bfloat16:
            assert_bf16_within(f"{name} {what}", got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=FWD_TOL,
                                       atol=FWD_TOL * float(ref.abs().max()))
    torch.testing.assert_close(stats[0], want_m, rtol=FWD_TOL, atol=1e-6)
    torch.testing.assert_close(stats[1], want_v, rtol=1e-4, atol=1e-5)
    for k, what in enumerate(("dscale", "dbias")):
        err = float((dsb[k] - want[1 + k]).abs().max())
        if err > BWD_TOL * float(want[1 + k].abs().max()):
            raise AssertionError(f"{name} {what}: max abs error {err:.3e}")


def main(rounds: int = ROUNDS, parents=()) -> int:
    if not torch.cuda.is_available():
        print("bn_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tag, (name, consts) in enumerate(VARIANTS.items()):
        src = out_dir / f"bn_stats_{tag}.cu"
        src.write_text(patched_source(consts))
        jobs.append((name, src, _build.CSRC_DIR, out_dir / f"libbn_{tag}.so"))
    src = out_dir / "bn_stats_trace.cu"
    src.write_text(traced_source({}))
    jobs.append(("trace", src, _build.CSRC_DIR, out_dir / "libbn_trace.so"))
    for k, d in enumerate(parents):
        csrc = Path(d).resolve() / "vitta_tpu_torch" / "csrc"
        jobs.append((f"parent {Path(d).name}", csrc / "bn_stats.cu", csrc,
                     out_dir / f"libbn_parent_{k}.so"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    builds = {}
    for name, lib, info in built:
        print(f"{name}:", flush=True)
        for line in info:
            print(f"  {line}", flush=True)
        if lib is not None:
            builds[name] = Build(name, lib)
    trace = builds.pop("trace", None)
    source = builds["as the source"]
    for dtype, wide in ((torch.float32, 4), (torch.bfloat16, 8)):
        for bwd in (False, True):
            for v in (wide, 1):
                out = (ctypes.c_longlong * 6)()
                source.lib.vitta_bn_stats_plan(
                    6272, 256, v, int(dtype == torch.bfloat16), int(bwd), out)
                print(f"resident clusters of 8, {'bwd' if bwd else 'fwd'} "
                      f"{str(dtype)[6:]} v={v}: {out[4]}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    order = list(builds)
    # (dtype, direction, build) -> per round, the pass's sums of device,
    # event and graph ms
    step, bounds = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for (r, c), sites in BN_SITES.items():
            x = (rand(r, c) * 2.0 + 0.5).to(dtype)
            scale = torch.rand(c, device=dev, generator=gen) + 0.5
            bias, mean = rand(c), rand(c) * 0.1
            var = torch.rand(c, device=dev, generator=gen) + 0.5
            g_y, g_m, g_v = rand(r, c).to(dtype), rand(c), rand(c)
            m = fused_bn_relu_stats_reference(x, scale, bias, mean, var,
                                              relu=False)[1].mean
            ins = (x, scale, bias, mean, var, m, g_y, g_m, g_v)
            runs = {}
            for name, b in builds.items():
                fwd, bwd, outs = b.calls(*ins)
                fwd(), bwd()
                first = [o.clone() for o in outs]
                fwd(), bwd()
                torch.cuda.synchronize()
                if not all(torch.equal(o, f) for o, f in zip(outs, first)):
                    raise AssertionError(f"{name} {r}x{c}: two runs differ")
                check_build(name, outs, *ins)
                runs[name] = {"fwd": fwd, "bwd": bwd}
            if trace is not None:
                fwd, bwd, outs = trace.calls(*ins)
                for d, fn in (("fwd", fwd), ("bwd", bwd)):
                    print_trace(trace.lib, fn, f"{d} {str(dtype)[6:]} {r}x{c}")
            nbytes = {"fwd": 2 * x.numel() * x.element_size() + 6 * c * 4,
                      "bwd": 3 * x.numel() * x.element_size() + 10 * c * 4}
            for d in ("fwd", "bwd"):
                times = {name: ([], [], []) for name in builds}
                for k in range(rounds):
                    for name in (order if k % 2 == 0 else order[::-1]):
                        fn = runs[name][d]
                        times[name][0].append(device_ms(fn))
                        times[name][1].append(event_ms(fn))
                        times[name][2].append(graph_ms(fn))
                bound = nbytes[d] / HBM_BYTES_PER_S * 1e3
                print(f"bn_stats {d} {str(dtype)[6:]} {r}x{c} ({sites} sites): "
                      f"device / event / graph ms a call, medians over "
                      f"{rounds} rounds; bound {bound * 1e3:.2f} us by bytes",
                      flush=True)
                for name in builds:
                    med = [statistics.median(v) for v in times[name]]
                    print(f"  {name}: {med[0] * 1e3:.2f} / {med[1] * 1e3:.2f} "
                          f"/ {med[2] * 1e3:.2f} us (device {bound / med[0]:.2f}"
                          f" of the bound)", flush=True)
                    sums = step.setdefault((dtype, d, name),
                                           [[0.0] * rounds for _ in range(3)])
                    for j in range(3):
                        for k in range(rounds):
                            sums[j][k] += sites * times[name][j][k]
                bounds[(dtype, d)] = bounds.get((dtype, d), 0.0) + sites * bound
            del x, g_y, ins, runs
    print(f"bn_stats per TANet adapt pass (29 sites, relu=False): device / "
          f"event / graph ms, median [least, most] of {rounds} rounds; on "
          f"{card}:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for d in ("fwd", "bwd"):
            print(f"  {d} {str(dtype)[6:]} (bound {bounds[(dtype, d)]:.4f} "
                  "ms by bytes):", flush=True)
            for name in builds:
                parts = []
                for v in step[(dtype, d, name)]:
                    parts.append(f"{statistics.median(v):.4f} [{min(v):.4f}, "
                                 f"{max(v):.4f}]")
                print(f"    {name}: " + " / ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    args, dirs = sys.argv[1:], []
    while "--parent" in args:
        at = args.index("--parent")
        dirs.append(args[at + 1])
        del args[at:at + 2]
    sys.exit(main(*(int(a) for a in args), parents=dirs))
