"""Time the LayerNorm backward at other shapes of its work, and in turns
with another checkout's, on the card.

    python3 -m vitta_tpu_torch.tools.ln_variants [--bf16] [--parent DIR ...] [rounds]

Float32 (the default): ``csrc/ln_rows.cuh`` and ``csrc/reduce.cuh`` fix
the choices of the float32 backward as constants: the rows a block takes
at least (``kLnBwdMinRows``), the blocks at most (``kLnBwdBlocks``), and,
in the second launch, the number of partials from which a sum is staged in
shared memory (``kStagedCount``) and how many it stages at once
(``kStageRows``); ``VARIANTS`` changes them.  ``--bf16``: ``csrc/ln.cu``
fixes those of the bfloat16 backward in 16-byte units (ln_bwd_bf16x8, one
launch): the rows a row group takes at least (``kLnB16MinSteps``, 1),
the units a lane holds at most (``kLnB16MaxUnits``, 3), the blocks of a
cluster (``kLnB16MaxCluster``, 8), the blocks an SM (``kLnB16BlocksPerSm``,
2) and the partials the last blocks load at once (``kLnB16SumAhead``, 32);
``BF16_VARIANTS`` changes them.  The script copies ``csrc/`` for each
entry with those constants changed and, with ``--parent``, takes each
``DIR``'s own ``vitta_tpu_torch/csrc/ln.cu`` (an unpacked ``git archive``
of another commit under ``build/``; its C interface is bound as it stands:
the bfloat16 entry without a slot of tickets where it has none).  It
builds them all at once with ``nvcc -Xptxas -v`` and prints the backward
kernels' registers and spills.  With ``--bf16`` it also builds a copy with
``%globaltimer`` timestamps at seven points of ln_bwd_bf16x8
(``TRACE_EDITS``) and prints, at ``TRACE_SITES``, the blocks' least /
median / most time of each point of one call.  With ``--parent`` it also builds
``mlp.cu`` and ``attention_proj.cu`` (the chains that run the float32
plan's LayerNorm backward with their own reduce) from this checkout and
from each ``DIR`` and says whether their machine code (``cuobjdump
-sass``) is the same.  At every LayerNorm site of a Swin-B and a Swin-T
backward pass of 2 clips (tools/ln_bias_sites.py) it checks every build
against the plain version (dx within one bfloat16 ulp at bfloat16 and
``TOL`` of its largest value at float32, dgamma and dbeta ``TOL`` of their
largest value) and that two runs give the same bits; then it times one
backward call of each build at each site, in turns over the rounds
(default ``ROUNDS``): device ms from torch.profiler (every launch of the
call) and ms a call of a CUDA graph's replay (the kernels back to back, the
gaps between them included), and prints per site the medians beside the
bound (bytes over 3.35 TB/s) and per pass the median, least and most of the
rounds' sums.  Needs a CUDA device and nvcc; the copies and their
libraries go to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from vitta_tpu_torch.ops import _build, cuda_ln
from vitta_tpu_torch.tools.ln_bias_sites import (SWIN_LN_SITES,
                                                 SWIN_T_LN_SITES)

# name -> constants of csrc/ changed; the first is the source's own
VARIANTS = {
    "as the source": {},
    "min rows 4": {"kLnBwdMinRows": 4},
    "min rows 16": {"kLnBwdMinRows": 16},
    "blocks 66": {"kLnBwdBlocks": 66},
    "staged from 1024 partials": {"kStagedCount": 1024},
    "stage 64 rows": {"kStageRows": 64},
}
BF16_VARIANTS = {
    "as the source": {},
    "sum ahead 16": {"kLnB16SumAhead": 16},
    "min steps 2": {"kLnB16MinSteps": 2},
    "clusters of 4": {"kLnB16MaxCluster": 4},
}
TOL = 1e-5
ROUNDS = 5

# The trace build (--bf16): the source with a timestamp (%globaltimer, ns)
# taken by each block's first thread at seven points of ln_bwd_bf16x8, into
# a device array read back by vitta_ln_trace.
TRACE_MARKS = ("start", "gamma and first row", "rows done", "block summed",
               "cluster summed, partial out", "ticket drawn",
               "end (the last blocks: sums out)")
TRACE_HEAD = """
__device__ unsigned long long g_ln_trace[1 << 16];
__device__ __forceinline__ void ln_mark(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_ln_trace[(unsigned long long)blockIdx.x * 8 + k] = t;
  }
}
"""
TRACE_TAIL = """
extern "C" int vitta_ln_trace(unsigned long long* host, int n, int clear) {
  void* at = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&at, g_ln_trace);
  if (e == cudaSuccess && n > 0)
    e = cudaMemcpy(host, at, n * sizeof(unsigned long long),
                   cudaMemcpyDeviceToHost);
  if (e == cudaSuccess && clear)
    e = cudaMemset(at, 0, sizeof(unsigned long long) << 16);
  return (int)e;
}
"""
TRACE_EDITS = (
    ('#include "tickets.cuh"\n', TRACE_HEAD, "after"),
    ("  const int n = c >> 3;\n", "  ln_mark(0);\n", "after"),
    ("  const float inv_c = 1.0f / c;\n", "  ln_mark(1);\n", "before"),
    ("  // the row groups of a warp added in a butterfly", "  ln_mark(2);\n",
     "before"),
    ("  // the cluster's blocks in rank order, a slice", "  ln_mark(3);\n",
     "before"),
    ("  __syncthreads();\n  if (tid == 0)\n    last = draw_last_ticket",
     "  ln_mark(4);\n", "before"),
    ("  if (last) {\n    for (int col = lo + tid;", "  ln_mark(5);\n",
     "before"),
    ("      dgb[col] = s;\n    }\n  }\n", "  ln_mark(6);\n", "after"),
)
TRACE_SITES = ((3136, 512), (50176, 128), (784, 2048))


def traced_csrc() -> Path:
    """A copy of csrc/ whose ln.cu takes the trace's marks."""
    src_dir = copy_csrc("trace", {})
    path = src_dir / "ln.cu"
    src = path.read_text()
    for anchor, text, where in TRACE_EDITS:
        if anchor not in src:
            raise SystemExit(f"ln.cu: no {anchor!r} to trace at")
        src = src.replace(anchor, anchor + text if where == "after"
                          else text + anchor)
    path.write_text(src + TRACE_TAIL)
    return src_dir


def print_trace(lib, run, label):
    """Run ``run`` once more after a warm one and print, per mark, the
    least, median and most time of the blocks that reached it, in us from
    the first block's start."""
    import numpy as np
    read = lib.vitta_ln_trace
    read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    read.restype = ctypes.c_int
    run()
    torch.cuda.synchronize()
    if read(None, 0, 1) != 0:
        raise RuntimeError("vitta_ln_trace failed")
    run()
    torch.cuda.synchronize()
    buf = np.zeros(1 << 16, dtype=np.uint64)
    if read(buf.ctypes.data, 1 << 16, 1) != 0:
        raise RuntimeError("vitta_ln_trace failed")
    marks = buf.reshape(-1, 8).astype(np.int64)
    marks = marks[marks[:, 0] > 0]
    t0 = marks[:, 0].min()
    parts = []
    for k, name in enumerate(TRACE_MARKS):
        at = marks[:, k][marks[:, k] > 0] - t0
        if len(at):
            parts.append(f"{name} {at.min() / 1e3:.2f}/{np.median(at) / 1e3:.2f}"
                         f"/{at.max() / 1e3:.2f}")
    print(f"  trace {label} ({len(marks)} blocks; us least/median/most): "
          + ", ".join(parts), flush=True)
HBM_BYTES_PER_S = 3.35e12


def copy_csrc(tag: str, consts: dict) -> Path:
    """A copy of csrc/ with the given ``constexpr int`` constants changed
    (each must occur once over its files)."""
    src_dir = _build.BUILD_DIR / "variants" / f"ln_{tag}"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    shutil.copytree(_build.CSRC_DIR, src_dir)
    for name, value in consts.items():
        hits = 0
        for path in [*src_dir.glob("*.cuh"), *src_dir.glob("*.cu")]:
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", path.read_text())
            path.write_text(text)
            hits += n
        if hits != 1:
            raise SystemExit(f"csrc/ holds no one constant {name}")
    return src_dir


def nvcc(src: Path, out: Path):
    """nvcc with -Xptxas -v; the finished process."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(src.parent), "-o", str(out), str(src)]
    return subprocess.run(cmd, capture_output=True, text=True)


def ptxas_lines(stderr: str, bf16: bool):
    """"kernel: registers, spills" of the LayerNorm backward's kernels."""
    lines = stderr.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1]
        keep = ("ln_bwd_bf16x8" in name or "ln_bwd_kernelILb1ELi" in name
                and "bfloat16" in name) if bf16 else (
            "ln_bwd_kernelILb1" in name and "bfloat16" not in name
            or "reduce_partials" in name)
        if keep:
            info = " ".join(x.replace("ptxas info    :", "").strip()
                            for x in lines[k + 1:k + 4]
                            if "spill" in x or "registers" in x)
            yield f"{name[-60:]}: {info}"


class Build:
    """One library's backward by its own C interface."""

    def __init__(self, name: str, lib):
        self.name, self.lib = name, lib
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        self.slotted = hasattr(lib, "vitta_ln_slots")
        lib.vitta_ln_bwd.argtypes = [p] * 6 + [ll, i, f, i, p]
        lib.vitta_ln_bwd.restype = i
        lib.vitta_ln_bwd_bf16.argtypes = [p] * 6 + [ll, i, f, i] + (
            [i, p] if self.slotted else [p])
        lib.vitta_ln_bwd_bf16.restype = i
        lib.vitta_ln_bwd_scratch_floats.argtypes = [ll, i]
        lib.vitta_ln_bwd_scratch_floats.restype = ll
        if self.slotted:
            lib.vitta_ln_bwd_bf16_scratch_floats.argtypes = [ll, i]
            lib.vitta_ln_bwd_bf16_scratch_floats.restype = ll

    def call(self, x, g, dy):
        """A function of no argument that runs one backward call into
        outputs made here; and the outputs (dx, dgb)."""
        rows, c = x.shape
        lib = self.lib
        dx = torch.empty_like(x)
        dgb = torch.empty(2, c, device=x.device)
        if x.dtype == torch.bfloat16 and self.slotted:
            vec = cuda_ln.bwd_vec_bf16(c, x, g, dy, dx)
            floats = (lib.vitta_ln_bwd_bf16_scratch_floats(rows, c)
                      if vec == 2 else lib.vitta_ln_bwd_scratch_floats(rows, c))
            extra = (0,)                              # slot 0 of its tickets
        else:
            vec = cuda_ln.bwd_vec(c, x, g, dy, dx)
            floats = lib.vitta_ln_bwd_scratch_floats(rows, c)
            extra = ()
        scratch = torch.empty(floats, device=x.device)
        entry = (lib.vitta_ln_bwd_bf16 if x.dtype == torch.bfloat16
                 else lib.vitta_ln_bwd)

        def run():
            code = entry(x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                         dx.data_ptr(), dgb.data_ptr(), scratch.data_ptr(),
                         rows, c, 1e-5, vec, *extra,
                         torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{self.name}: CUDA error {code}")
        return run, (dx, dgb)


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


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """ms per call of a CUDA graph of ``calls`` calls of ``fn`` (median of
    ``reps`` replays)."""
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


def check(name, outs, x, g, dy):
    """Raise unless one build's outputs are the plain version's within the
    tolerances of the module docstring."""
    from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
    dx, dgb = outs
    want = cuda_ln.layer_norm_backward_reference(x, g, dy, 1e-5)
    if x.dtype == torch.bfloat16:
        assert_bf16_within(f"{name} dx", dx, want[0])
    else:
        err = float((dx - want[0]).abs().max())
        if err > TOL * float(want[0].abs().max()):
            raise AssertionError(f"{name} dx: max abs error {err:.3e}")
    for k, what in enumerate(("dgamma", "dbeta")):
        err = float((dgb[k] - want[1 + k]).abs().max())
        if err > TOL * float(want[1 + k].abs().max()):
            raise AssertionError(f"{name} {what}: max abs error {err:.3e}")


def same_sass(parents) -> None:
    """Print whether mlp.cu and attention_proj.cu compile to the same
    machine code here and in each parent (all builds at once)."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out_dir = _build.BUILD_DIR / "variants"
    trees = [("this checkout", _build.CSRC_DIR)] + [
        (f"parent {Path(d).name}",
         Path(d).resolve() / "vitta_tpu_torch" / "csrc") for d in parents]
    jobs = [(src, label, csrc / f"{src}.cu",
             out_dir / f"sass_{src}_{k}.so")
            for src in ("mlp", "attention_proj")
            for k, (label, csrc) in enumerate(trees)]

    def sass(job):
        src, label, path, lib = job
        if nvcc(path, lib).returncode != 0:
            return src, label, None
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        return src, label, "\n".join(l for l in text.splitlines()
                                     if "code for" not in l
                                     and "Fatbin" not in l)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(sass, jobs))
    for src in ("mlp", "attention_proj"):
        texts = {label: text for s, label, text in done if s == src}
        ref = texts["this checkout"]
        for label, text in texts.items():
            if label != "this checkout":
                print(f"{src}.cu machine code, this checkout against {label}: "
                      f"{'the same' if text == ref and ref else 'different'} "
                      f"({len((ref or '').splitlines())} lines)", flush=True)


def main(rounds: int = ROUNDS, parents=(), bf16: bool = False) -> int:
    if not torch.cuda.is_available():
        print("ln_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if bf16 else torch.float32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; LayerNorm backward at {str(dtype)[6:]}",
          flush=True)
    jobs = []
    for tag, (name, consts) in enumerate(
            (BF16_VARIANTS if bf16 else VARIANTS).items()):
        src_dir = copy_csrc(f"{'b' if bf16 else 'f'}{tag}", consts)
        jobs.append((name, src_dir / "ln.cu", src_dir / "libln.so"))
    out_dir = _build.BUILD_DIR / "variants"
    if bf16:
        trace_dir = traced_csrc()
        jobs.append(("trace", trace_dir / "ln.cu", trace_dir / "libln.so"))
    for k, d in enumerate(parents):
        csrc = Path(d).resolve() / "vitta_tpu_torch" / "csrc"
        jobs.append((f"parent {Path(d).name}", csrc / "ln.cu",
                     out_dir / f"libln_parent_{k}.so"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        procs = list(pool.map(lambda j: nvcc(j[1], j[2]), jobs))
    builds = {}
    for (name, _src, out), proc in zip(jobs, procs):
        print(f"{name}:", flush=True)
        if proc.returncode != 0:
            print(f"  nvcc failed:\n{proc.stderr[-2000:]}", flush=True)
            continue
        for line in ptxas_lines(proc.stderr, bf16):
            print(f"  {line}", flush=True)
        builds[name] = Build(name, ctypes.CDLL(str(out)))
    trace = builds.pop("trace", None)
    if trace is not None:
        gen = torch.Generator(device=dev).manual_seed(1)
        for rows, c in TRACE_SITES:
            x = (torch.randn(rows, c, device=dev, generator=gen) * 2
                 + 0.5).to(dtype)
            g = torch.randn(c, device=dev, generator=gen)
            dy = torch.randn(rows, c, device=dev, generator=gen).to(dtype)
            run, outs = trace.call(x, g, dy)
            run()
            check(f"trace {rows}x{c}", outs, x, g, dy)
            print_trace(trace.lib, run, f"{rows}x{c}")
    if parents:
        same_sass(parents)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(builds)
    step = {(name, model): [[0.0] * rounds for _ in range(2)]
            for name in builds for model in ("swin_b", "swin_t")}
    bounds = dict.fromkeys(("swin_b", "swin_t"), 0.0)
    for model, table in (("swin_b", SWIN_LN_SITES),
                         ("swin_t", SWIN_T_LN_SITES)):
        for (tokens, c), sites in table.items():
            rows = 2 * tokens
            x = (torch.randn(rows, c, device=dev, generator=gen) * 2
                 + 0.5).to(dtype)
            g = torch.randn(c, device=dev, generator=gen)
            dy = torch.randn(rows, c, device=dev, generator=gen).to(dtype)
            runs = {}
            for name, b in builds.items():
                run, outs = b.call(x, g, dy)
                run()
                first = [o.clone() for o in outs]
                run()
                torch.cuda.synchronize()
                if not all(torch.equal(o, f) for o, f in zip(outs, first)):
                    raise AssertionError(f"{name} {rows}x{c}: two runs differ")
                check(f"{name} {rows}x{c}", outs, x, g, dy)
                runs[name] = run
            times = {name: ([], []) for name in builds}
            for k in range(rounds):
                for name in (order if k % 2 == 0 else order[::-1]):
                    times[name][0].append(device_ms(runs[name]))
                    times[name][1].append(graph_ms(runs[name]))
            bound = ((3 * x.numel() * x.element_size() + 3 * c * 4)
                     / HBM_BYTES_PER_S * 1e3)
            bounds[model] += sites * bound
            print(f"ln bwd {model} {rows}x{c} ({sites} sites): device / graph "
                  f"us a call, medians over {rounds} rounds; bound "
                  f"{bound * 1e3:.2f} us by bytes", flush=True)
            for name in builds:
                med = [statistics.median(v) for v in times[name]]
                print(f"  {name}: {med[0] * 1e3:.2f} / {med[1] * 1e3:.2f} "
                      f"(graph {bound / med[1]:.2f} of the bound)", flush=True)
                for j in range(2):
                    for k in range(rounds):
                        step[(name, model)][j][k] += sites * times[name][j][k]
            del x, dy, runs
    print(f"ln bwd {str(dtype)[6:]} per pass of 2 clips: device / graph ms, "
          f"median [least, most] of {rounds} rounds; on {card}:", flush=True)
    for model in ("swin_b", "swin_t"):
        print(f"  {model} (bound {bounds[model]:.4f} ms by bytes):",
              flush=True)
        for name in builds:
            print(f"    {name}: " + " / ".join(
                f"{statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
                for v in step[(name, model)]), flush=True)
    return 0


if __name__ == "__main__":
    args, dirs = sys.argv[1:], []
    while "--parent" in args:
        at = args.index("--parent")
        dirs.append(args[at + 1])
        del args[at:at + 2]
    wide = "--bf16" in args
    args = [a for a in args if a != "--bf16"]
    raise SystemExit(main(*(int(a) for a in args), parents=dirs, bf16=wide))
