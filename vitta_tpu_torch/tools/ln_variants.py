"""Time the LayerNorm backward, or the bfloat16 forward, at other shapes of
its work, and in turns with another checkout's, on the card.

    python3 -m vitta_tpu_torch.tools.ln_variants [--bf16 | --fwd] [--parent DIR ...] [rounds]

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
rounds' sums.

``--fwd``: the bfloat16 forward (``csrc/ln_rows.cuh``: ln_fwd_bf16x8, one
launch a call).  ``FWD_VARIANTS`` changes its constants (the block's
threads ``kLnF16Threads``, the rows a short row's group takes at once
``kLnF16Batch``), and a copy with programmatic dependent launch
(``PDL_EDITS``: each launch may start before the one before it ends and
waits for it in the kernel, ``griddepcontrol``) joins them; with
``--parent`` each ``DIR``'s ``ln.cu`` joins too.  Two more builds of this
checkout and of each ``DIR`` take ``%globaltimer`` marks (``FWD_TRACE_EDITS``,
whose anchors fit the older ln_rows_bf16x8 and ln_fwd_bf16x8: first load,
row sums done, gamma and beta ready, last store) at ``FWD_TRACE_SITES``,
each beside an empty kernel of the same grid timed by the same graph
replays.  At every LayerNorm site of a Swin-B and a Swin-T forward pass
(tools/ln_bias_sites.py) at 1 and 2 clips it checks every build (y within
one bfloat16 ulp of ``layer_norm_reference``, two runs the same bits, one
launch a call by the library's own counts, this checkout's plan the
mirror's ``cuda_ln.ln_fwd_bf16_plan``), then times each build and
``F.layer_norm`` at bfloat16 in turns (device ms from torch.profiler and
ms a call of a CUDA graph's replay) and prints per site the medians
beside the bound (x read and y written, gamma and beta read, over 3.35
TB/s) and per pass and clips the median, least and most of the rounds'
sums.  With ``--parent`` it also says whether every kernel of ``ln.cu``,
``mlp.cu`` and ``attention_proj.cu`` but the bfloat16 forward's compiles
to the same machine code here and in each ``DIR`` (``cuobjdump -sass``,
function by function), and times in turns, from those builds, the two
chains whose first step is the bfloat16 forward: the LayerNorm-MLP
forward (``vitta_lnmlp_fwd_bf16``, PERF.md row 10 bf16) and the
projection-fused attention with the LayerNorm (``vitta_attn_ln_proj_fwd_bf16``,
row 18 bf16, dense bias) at every Swin-B stage of 2 clips, per pass.
Needs a CUDA device and nvcc; the copies and their libraries go to
``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import difflib
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


def sass_functions(text: str) -> dict:
    """{function: its machine code} of ``cuobjdump -sass``'s output, with
    the anonymous namespace's name (which nvcc draws from the file's
    contents) made the same for every file, and each line's runs of blanks
    made one (cuobjdump pads its columns to the file's widest
    instruction)."""
    text = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", text)
    out, name, lines = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = "\n".join(lines)
            name, lines = m.group(1), []
        elif name is not None and "code for" not in line \
                and "Fatbin" not in line:
            lines.append(" ".join(line.split()))
    if name is not None:
        out[name] = "\n".join(lines)
    return out


def same_sass(parents, sources=("mlp", "attention_proj"), skip=()):
    """Print whether each of ``sources`` (csrc/<name>.cu) compiles to the
    same machine code here and in each parent, function by function,
    leaving out the functions whose names hold one of ``skip`` (all builds
    at once); returns {(source, tree label): library path} of the builds."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out_dir = _build.BUILD_DIR / "variants"
    trees = [("this checkout", _build.CSRC_DIR)] + [
        (f"parent {Path(d).name}",
         Path(d).resolve() / "vitta_tpu_torch" / "csrc") for d in parents]
    jobs = [(src, label, csrc / f"{src}.cu",
             out_dir / f"sass_{src}_{k}.so")
            for src in sources
            for k, (label, csrc) in enumerate(trees)]

    def sass(job):
        src, label, path, lib = job
        if nvcc(path, lib).returncode != 0:
            return src, label, None
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        return src, label, sass_functions(text)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(sass, jobs))
    for src in sources:
        funcs = {label: {k: v for k, v in (f or {}).items()
                         if not any(x in k for x in skip)}
                 for s_, label, f in done if s_ == src}
        ref = funcs["this checkout"]
        for label, got in funcs.items():
            if label == "this checkout":
                continue
            differ = sorted(k for k in set(ref) & set(got)
                            if ref[k] != got[k])
            alone = sorted(set(ref) ^ set(got))
            verdict = ("the same" if ref and not differ and not alone else
                       f"{len(differ)} functions of both differ, "
                       f"{len(alone)} are in one only: "
                       + ", ".join(d[:80] for d in (differ + alone)[:8]))
            print(f"{src}.cu machine code, this checkout against {label}: "
                  f"{verdict} ({len(ref)} functions"
                  + (f", leaving out those named {', '.join(skip)}"
                     if skip else "") + ")", flush=True)
            for k in differ[:2]:            # where they part
                lines = list(difflib.unified_diff(
                    got[k].splitlines(), ref[k].splitlines(), lineterm="",
                    n=1))
                print(f"  {k[:80]}:\n    " + "\n    ".join(lines[2:14]),
                      flush=True)
    return {(src, label): lib for (src, label, _p, lib) in jobs}


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


# ---------------------------------------------------------------- forward

FWD_VARIANTS = {
    "as the source": {},
    "no batch": {"kLnF16Batch": 1},
    "blocks of 256": {"kLnF16Threads": 256},
    "blocks of 256, no batch": {"kLnF16Threads": 256, "kLnF16Batch": 1},
}
# the programmatic-dependent-launch copy: the kernel waits for the launch
# before it (griddepcontrol.wait) before it touches memory and lets the next
# one start at once; the launch carries the attribute
PDL_EDITS = (
    ("  const long long steps = (r1 - r0 + G * B - 1) / (G * B);\n",
     '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n',
     "after"),
    ("    ln_fwd_bf16x8<U, L><<<(unsigned)q.blocks, kLnF16Threads, 0, stream>>>("
     "   \\\n"
     "        x, gamma, beta, y, rows, c, q.chunk, eps);"
     "                           \\\n",
     "    {                                                                 "
     "     \\\n"
     "      cudaLaunchConfig_t cfg = {};                                    "
     "     \\\n"
     "      cfg.gridDim = dim3((unsigned)q.blocks);                         "
     "     \\\n"
     "      cfg.blockDim = dim3(kLnF16Threads);                             "
     "     \\\n"
     "      cfg.stream = stream;                                            "
     "     \\\n"
     "      cudaLaunchAttribute attr;                                       "
     "     \\\n"
     "      attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;   "
     "     \\\n"
     "      attr.val.programmaticStreamSerializationAllowed = 1;            "
     "     \\\n"
     "      cfg.attrs = &attr;                                              "
     "     \\\n"
     "      cfg.numAttrs = 1;                                               "
     "     \\\n"
     "      cudaLaunchKernelEx(&cfg, ln_fwd_bf16x8<U, L>, x, gamma, beta, y, "
     "     \\\n"
     "                         rows, c, q.chunk, eps);                      "
     "     \\\n"
     "    }                                                                 "
     "     \\\n",
     "replace"),
)
FWD_TRACE_MARKS = ("first load", "row sums done", "gamma and beta ready",
                   "last store")
FWD_TRACE_HEAD = TRACE_HEAD + """
__device__ __forceinline__ void ln_wait(float v) {
  if (__float_as_uint(v) == 0x7fbadbadu) asm volatile("trap;");
}
"""
FWD_TRACE_TAIL = TRACE_TAIL.replace("g_ln_trace", "vitta::g_ln_trace") + """
__global__ void ln_empty_kernel() {}
extern "C" int vitta_ln_empty(int blocks, int threads, void* stream) {
  ln_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
# (edits of ln_rows.cuh) for each kernel the forward may be: the older
# ln_rows_bf16x8 (gamma and beta loaded after the sums: the mark waits for
# the first unit's) and ln_fwd_bf16x8
FWD_TRACE_EDITS = {
    "ln_rows_bf16x8": (
        ("  const bool ok = row < rows;\n", "  ln_mark(0);\n", "after"),
        ("  if (!ok) return;\n", "  ln_mark(1);\n", "before"),
        ("    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, "
         "b1.w};\n",
         "    if (i == 0) {\n      ln_wait(g[7] + b[7]);\n      ln_mark(2);\n"
         "    }\n", "after"),
        ("                   pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));\n"
         "  }\n}\n", "  ln_mark(3);\n", "before_last_brace")),
    "ln_fwd_bf16x8": (
        ("  ln_fwd_load<U, L, B>(x, row, r1, n, sub, v);\n"
         "  // this lane's gamma", "  ln_mark(0);\n", "before"),
        ("      bt[i][1] = reinterpret_cast<const float4*>(beta)[2 * u + 1];\n"
         "    }\n  }\n",
         "  ln_wait(gm[0][0].x + bt[0][0].x);\n  ln_mark(2);\n", "after"),
        ("      rstd[b] = rsqrtf(s2 * inv_c - mu[b] * mu[b] + eps);\n    }\n",
         "    if (s == 0) ln_mark(1);\n", "after"),
        ("                       pack_bf16(o[4], o[5]), pack_bf16(o[6], "
         "o[7]));\n      }\n    }\n  }\n}\n", "  ln_mark(3);\n",
         "before_last_brace")),
}
FWD_TRACE_SITES = ((3136, 512), (784, 2048))


def edit_source(path: Path, edits) -> None:
    """Apply (anchor, text, where) edits to ``path``; each anchor must occur
    once.  where: "after", "before", "replace", or "before_last_brace"
    (the text goes before the anchor's closing brace line)."""
    src = path.read_text()
    for anchor, text, where in edits:
        if src.count(anchor) != 1:
            raise SystemExit(f"{path.name}: no one {anchor[:60]!r} to edit")
        if where == "after":
            new = anchor + text
        elif where == "before":
            new = text + anchor
        elif where == "replace":
            new = text
        else:
            new = anchor[:-2] + text + "}\n"
        src = src.replace(anchor, new)
    path.write_text(src)


def fwd_copy(tag: str, csrc: Path, consts: dict, edits=()) -> Path:
    """A copy of ``csrc`` with constants changed (copy_csrc's rule) and
    ln_rows.cuh edited; returns the copy's ln.cu."""
    src_dir = _build.BUILD_DIR / "variants" / f"lnf_{tag}"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    shutil.copytree(csrc, src_dir)
    for name, value in consts.items():
        path = src_dir / "ln_rows.cuh"
        text, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", path.read_text())
        if hits != 1:
            raise SystemExit(f"ln_rows.cuh holds no one constant {name}")
        path.write_text(text)
    if edits:
        edit_source(src_dir / "ln_rows.cuh", edits)
    return src_dir / "ln.cu"


def traced_fwd(tag: str, csrc: Path):
    """A copy of ``csrc`` whose bfloat16 forward takes the trace's marks:
    its ln.cu, and the forward's block size."""
    src = fwd_copy(tag, csrc, {})
    rows_h = src.parent / "ln_rows.cuh"
    text = rows_h.read_text()
    kernel = next(k for k in FWD_TRACE_EDITS if f"\n{k}(" in text)
    threads = (re.search(r"constexpr int kLnF16Threads = (\d+);", text)
               or re.search(r"constexpr int kLnThreads = (\d+);", text))
    edit_source(rows_h, (('#include "reduce.cuh"\n\nnamespace vitta {\n',
                          FWD_TRACE_HEAD, "after"),
                         *FWD_TRACE_EDITS[kernel]))
    src.write_text(src.read_text() + FWD_TRACE_TAIL)
    return src, int(threads.group(1))


def print_fwd_trace(lib, run, label, threads):
    """The trace's marks of one call after a warm one (print_trace's
    reading), then an empty kernel of the same grid by the same graph
    replays."""
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
    for k, name in enumerate(FWD_TRACE_MARKS):
        at = marks[:, k][marks[:, k] > 0] - t0
        if len(at):
            parts.append(f"{name} {at.min() / 1e3:.2f}/"
                         f"{np.median(at) / 1e3:.2f}/{at.max() / 1e3:.2f}")
    lib.vitta_ln_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.vitta_ln_empty.restype = ctypes.c_int
    blocks = len(marks)

    def empty():
        lib.vitta_ln_empty(blocks, threads,
                           torch.cuda.current_stream().cuda_stream)
    # graphs of 20 calls (this tool's) and of 5 (chip_smoke.py's graph_ms):
    # the graph's own launch is shared by fewer calls in the second
    e20, e5 = graph_ms(empty), graph_ms(empty, calls=5)
    print(f"  trace {label} ({blocks} blocks; us least/median/most from the "
          f"first block's first load): " + ", ".join(parts)
          + f"; an empty kernel of {blocks} blocks of {threads} threads "
          f"{e20 * 1e3:.2f} us a call in graphs of 20 calls, "
          f"{e5 * 1e3:.2f} in graphs of 5", flush=True)


def launch_names(lib) -> dict:
    """{kernel: launches} of one library so far, by its own counts."""
    fn = lib.vitta_launch_counts
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(None, 0)
    buf = ctypes.create_string_buffer(n + 1)
    fn(buf, n + 1)
    out = {}
    for line in buf.value.decode().splitlines():
        name, count = line.rsplit("\t", 1)
        out[name] = int(count)
    return out


class FwdBuild:
    """One library's bfloat16 forward by its own C interface."""

    def __init__(self, name: str, lib):
        self.name, self.lib = name, lib
        p = ctypes.c_void_p
        lib.vitta_ln_fwd_bf16.argtypes = [p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, p]
        lib.vitta_ln_fwd_bf16.restype = ctypes.c_int

    def call(self, x, g, b):
        """A function of no argument that runs one forward call into y,
        made here; and y."""
        rows, c = x.shape
        y = torch.empty_like(x)
        entry = self.lib.vitta_ln_fwd_bf16

        def run():
            code = entry(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                         y.data_ptr(), rows, c, 1e-5,
                         torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{self.name}: CUDA error {code}")
        return run, y

    def one_launch(self, run) -> str:
        """The one kernel a call launches (raises on more or fewer)."""
        before = launch_names(self.lib)
        run()
        after = launch_names(self.lib)
        ran = {k: n - before.get(k, 0) for k, n in after.items()
               if n != before.get(k, 0)}
        if sum(ran.values()) != 1:
            raise AssertionError(f"{self.name}: launches {ran} a call")
        return next(iter(ran))

    def plan(self, rows, c) -> dict:
        keys = cuda_ln.F16_PLAN_KEYS + ("per_sm", "sms")
        out = (ctypes.c_longlong * len(keys))()
        fn = self.lib.vitta_ln_fwd_bf16_plan
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = None
        fn(rows, c, out)
        return dict(zip(keys, out))


def fwd_sites():
    """(model, clips, rows, c, sites) of every LayerNorm site of a Swin-B
    and a Swin-T forward pass at 1 and 2 clips."""
    for model, table in (("swin_b", SWIN_LN_SITES),
                         ("swin_t", SWIN_T_LN_SITES)):
        for (tokens, c), sites in table.items():
            for clips in (1, 2):
                yield model, clips, clips * tokens, c, sites


def chain_turns(libs, rounds, dev):
    """Row 10 bf16 and row 18 bf16's forward from each tree's mlp.cu and
    attention_proj.cu, in turns: device ms a Swin-B pass of 2 clips (CUDA
    graph replays), median [least, most] over the rounds."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    labels = sorted({label for (_src, label) in libs},
                    key=lambda l: l != "this checkout")
    mlp, proj = {}, {}
    for label in labels:
        lm = ctypes.CDLL(str(libs[("mlp", label)]))
        lm.vitta_lnmlp_fwd_bf16.argtypes = [p] * 11 + [i, i, i, f, p]
        lm.vitta_lnmlp_fwd_bf16.restype = i
        mlp[label] = lm.vitta_lnmlp_fwd_bf16
        la = ctypes.CDLL(str(libs[("attention_proj", label)]))
        la.vitta_attn_ln_proj_fwd_bf16.argtypes = [p] * 14 + [
            i, i, i, i, i, f, f, p, p]
        la.vitta_attn_ln_proj_fwd_bf16.restype = i
        proj[label] = la.vitta_attn_ln_proj_fwd_bf16
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(dtype)
    sums = {(k, l): [0.0] * rounds for k in ("mlp", "proj") for l in labels}
    n_tok = 8 * 7 * 7
    # Swin-B stages: (C, heads, tokens a clip, windows of the mask, blocks)
    for c, nh, tokens, nw, depth in ((128, 4, 25088, 64, 2),
                                     (256, 8, 6272, 16, 2),
                                     (512, 16, 1568, 4, 18),
                                     (1024, 32, 392, 1, 2)):
        m, hd = 2 * tokens, c // nh
        x, g, b = rnd(m, c, scale=2.0), rnd(c, dtype=torch.float32), \
            rnd(c, dtype=torch.float32)
        w1, b1, w2, b2 = rnd(4 * c, c, scale=c ** -0.5), rnd(4 * c), \
            rnd(c, 4 * c, scale=(4 * c) ** -0.5), rnd(c)
        y, a, o = torch.empty_like(x), rnd(m, 4 * c), torch.empty_like(x)
        wqkv, bqkv = rnd(3 * c, c, scale=c ** -0.5), rnd(3 * c)
        wproj, bproj = rnd(c, c, scale=c ** -0.5), rnd(c)
        bias = rnd(nh, n_tok, n_tok, scale=0.5, dtype=torch.float32)
        mask = (torch.where(torch.rand(nw, n_tok, n_tok, device=dev,
                                       generator=gen) < 0.3, -100.0, 0.0)
                if nw > 1 else None)
        qkv, oat, out = rnd(m, 3 * c), rnd(m, c), torch.empty_like(x)
        b_ = m // n_tok
        st = lambda: torch.cuda.current_stream().cuda_stream
        runs = {}
        for label in labels:
            fm, fp = mlp[label], proj[label]

            def run_mlp(fm=fm):
                code = fm(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                          w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                          b2.data_ptr(), y.data_ptr(), a.data_ptr(), None,
                          o.data_ptr(), m, c, 4 * c, 1e-5, st())
                if code != 0:
                    raise RuntimeError(f"lnmlp_fwd_bf16: CUDA error {code}")

            def run_proj(fp=fp):
                code = fp(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                          wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
                          bproj.data_ptr(), bias.data_ptr(),
                          None if mask is None else mask.data_ptr(),
                          y.data_ptr(), qkv.data_ptr(), oat.data_ptr(), None,
                          out.data_ptr(), b_, n_tok, nh, hd, nw, 1e-5,
                          hd ** -0.5, None, st())
                if code != 0:
                    raise RuntimeError(f"ln_proj_fwd_bf16: CUDA error {code}")
            runs[("mlp", label)], runs[("proj", label)] = run_mlp, run_proj
        for kind in ("mlp", "proj"):
            ys = []
            for label in labels:
                runs[(kind, label)]()
                torch.cuda.synchronize()
                ys.append(y.clone())
            from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
            want = cuda_ln.layer_norm_reference(x, g, b, 1e-5)
            for label, got in zip(labels, ys):
                assert_bf16_within(f"{kind} {label} y C={c}", got, want)
        for k in range(rounds):
            for label in (labels if k % 2 == 0 else labels[::-1]):
                for kind in ("mlp", "proj"):
                    sums[(kind, label)][k] += depth * graph_ms(
                        runs[(kind, label)])
        del x, y, a, o, qkv, oat, out, bias, mask
    for kind, what in (("mlp", "LayerNorm-MLP forward (row 10 bf16)"),
                       ("proj", "attn_ln_proj forward (row 18 bf16, dense "
                                "bias)")):
        print(f"{what} per Swin-B pass of 2 clips, graph ms, median [least, "
              f"most] of {rounds} rounds:", flush=True)
        for label in labels:
            v = sums[(kind, label)]
            print(f"  {label}: {statistics.median(v):.4f} [{min(v):.4f}, "
                  f"{max(v):.4f}]", flush=True)


def main_fwd(rounds: int = ROUNDS, parents=()) -> int:
    import torch.nn.functional as F
    from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
    if not torch.cuda.is_available():
        print("ln_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; LayerNorm forward at bfloat16", flush=True)
    jobs = []
    for tag, (name, consts) in enumerate(FWD_VARIANTS.items()):
        jobs.append((name, fwd_copy(f"v{tag}", _build.CSRC_DIR, consts)))
    jobs.append(("PDL", fwd_copy("pdl", _build.CSRC_DIR, {}, PDL_EDITS)))
    threads = {}                   # a trace build -> its forward's block
    src, threads["trace"] = traced_fwd("trace", _build.CSRC_DIR)
    jobs.append(("trace", src))
    for k, d in enumerate(parents):
        csrc = Path(d).resolve() / "vitta_tpu_torch" / "csrc"
        jobs.append((f"parent {Path(d).name}", csrc / "ln.cu"))
        name = f"trace parent {Path(d).name}"
        src, threads[name] = traced_fwd(f"trace_p{k}", csrc)
        jobs.append((name, src))
    out_dir = _build.BUILD_DIR / "variants"
    libs = [out_dir / f"liblnf_{k}.so" for k in range(len(jobs))]
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 4) as pool:
        sass = pool.submit(same_sass, parents, ("ln", "mlp",
                                                "attention_proj"),
                           ("ln_rows_bf16x8", "ln_fwd_bf16x8")) \
            if parents else None
        procs = list(pool.map(lambda j: nvcc(j[0][1], j[1]),
                              zip(jobs, libs)))
        sass_libs = sass.result() if sass is not None else None
    builds, traces = {}, {}
    for (name, _src), out, proc in zip(jobs, libs, procs):
        if proc.returncode != 0:
            print(f"{name}: nvcc failed:\n{proc.stderr[-3000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(out))
        (traces if name.startswith("trace") else builds)[name] = \
            FwdBuild(name, lib)
        print(f"{name}: built", flush=True)
        for line in fwd_ptxas_lines(proc.stderr):
            print(f"  {line}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, tb in traces.items():
        for rows, c in FWD_TRACE_SITES:
            x = (torch.randn(rows, c, device=dev, generator=gen) * 2
                 + 0.5).to(torch.bfloat16)
            g = torch.randn(c, device=dev, generator=gen)
            b = torch.randn(c, device=dev, generator=gen)
            run, y = tb.call(x, g, b)
            run()
            assert_bf16_within(f"{name} {rows}x{c} y", y,
                               cuda_ln.layer_norm_reference(x, g, b, 1e-5))
            print_fwd_trace(tb.lib, run, f"{name} {rows}x{c}",
                            threads[name])
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(builds) + ["F.layer_norm"]
    keys = [(model, clips) for model in ("swin_b", "swin_t")
            for clips in (1, 2)]
    step = {(name, key): [[0.0] * rounds for _ in range(2)]
            for name in order for key in keys}
    bounds = dict.fromkeys(keys, 0.0)
    for model, clips, rows, c, sites in fwd_sites():
        x = (torch.randn(rows, c, device=dev, generator=gen) * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(c, device=dev, generator=gen)
        b = torch.randn(c, device=dev, generator=gen)
        gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
        want = cuda_ln.layer_norm_reference(x, g, b, 1e-5)
        runs, kernels = {}, {}
        for name, fb in builds.items():
            run, y = fb.call(x, g, b)
            kernels[name] = fb.one_launch(run)
            first = y.clone()
            run()
            torch.cuda.synchronize()
            if not torch.equal(y, first):
                raise AssertionError(f"{name} {rows}x{c}: two runs differ")
            assert_bf16_within(f"{name} {rows}x{c} y", y, want)
            runs[name] = run
        mine = builds.get("as the source")
        if mine is not None:
            plan = mine.plan(rows, c)
            mirror = cuda_ln.ln_fwd_bf16_plan(rows, c, plan["per_sm"],
                                              plan["sms"])
            if {k: plan[k] for k in mirror} != mirror or \
                    kernels["as the source"] != (
                        f"ln_fwd_bf16x8<{plan['units']}, {plan['lanes']}>"):
                raise AssertionError(f"{rows}x{c}: plan {plan}, mirror "
                                     f"{mirror}, kernel "
                                     f"{kernels['as the source']}")
        runs["F.layer_norm"] = lambda: F.layer_norm(x, (c,), gb, bb, 1e-5)
        times = {name: ([], []) for name in order}
        for k in range(rounds):
            for name in (order if k % 2 == 0 else order[::-1]):
                times[name][0].append(device_ms(runs[name]))
                times[name][1].append(graph_ms(runs[name]))
        bound = (2 * x.numel() * 2 + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
        bounds[(model, clips)] += sites * bound
        print(f"ln fwd bf16 {model} {rows}x{c} ({sites} sites): device / "
              f"graph us a call, medians over {rounds} rounds; bound "
              f"{bound * 1e3:.2f} us by bytes", flush=True)
        for name in order:
            med = [statistics.median(v) for v in times[name]]
            what = kernels.get(name, "")
            print(f"  {name}: {med[0] * 1e3:.2f} / {med[1] * 1e3:.2f} "
                  f"(graph {bound / med[1]:.2f} of the bound) {what}",
                  flush=True)
            for j in range(2):
                for k in range(rounds):
                    step[(name, (model, clips))][j][k] += \
                        sites * times[name][j][k]
        del x, runs
    print(f"ln fwd bf16 per pass: device / graph ms, median [least, most] of "
          f"{rounds} rounds; on {card}:", flush=True)
    for key in keys:
        print(f"  {key[0]}, {key[1]} clip(s) (bound {bounds[key]:.4f} ms by "
              f"bytes):", flush=True)
        for name in order:
            print(f"    {name}: " + " / ".join(
                f"{statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
                for v in step[(name, key)]), flush=True)
    if sass_libs is not None:
        chain_turns(sass_libs, rounds, dev)
    return 0


def fwd_ptxas_lines(stderr: str):
    """"kernel: registers, spills" of the bfloat16 forward's kernels."""
    lines = stderr.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1]
        if "ln_fwd_bf16x8" in name or "ln_rows_bf16x8" in name:
            info = " ".join(x.replace("ptxas info    :", "").strip()
                            for x in lines[k + 1:k + 4]
                            if "spill" in x or "registers" in x)
            yield f"{name[-40:]}: {info}"


if __name__ == "__main__":
    args, dirs = sys.argv[1:], []
    while "--parent" in args:
        at = args.index("--parent")
        dirs.append(args[at + 1])
        del args[at:at + 2]
    wide, fwd = "--bf16" in args, "--fwd" in args
    args = [a for a in args if a not in ("--bf16", "--fwd")]
    if fwd:
        raise SystemExit(main_fwd(*(int(a) for a in args), parents=dirs))
    raise SystemExit(main(*(int(a) for a in args), parents=dirs, bf16=wide))
