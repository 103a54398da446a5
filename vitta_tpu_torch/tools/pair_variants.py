"""Time the projection-fused attention backward's pairs of products in one
launch against two, on the card.

    python3 -m vitta_tpu_torch.tools.pair_variants

``csrc/attention_proj.cu``'s backward computes two pairs of products that do
not depend on each other: g_att = g wproj beside dwproj = g^T o_att (with
dbproj, the column sums of g), and dx = dqkv wqkv beside dwqkv = dqkv^T y
(with dbqkv).  ``launch_rows_and_grad`` (``csrc/gemm_tiles.cuh``) runs a
pair as one ``gemm_pair`` launch, both products at the weight gradient's
tile, or as two launches, the row product at ``launch_gemm``'s own tile;
``pair_grouped`` picks one.  This script builds a small library around that
launcher (``PAIR_SOURCE``) and, at every Swin-B and Swin-T stage shape of 2
clips, checks that both ways give the same bits, holds them against
``torch.matmul`` (TF32 off) within ``MLP_BWD_TOL`` of each output's largest
value, and prints the CUDA-event ms of each way, timed in turns (two, one,
one, two launches, three times; medians and ranges), beside what
``pair_grouped`` picks.  Needs a CUDA
device and nvcc; the library goes to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from vitta_tpu_torch.ops import _build

PAIR_SOURCE = r"""
#include "gemm_tiles.cuh"
using namespace vitta;
// the pair as attention_proj.cu's backward launches it; grouped < 0: as
// pair_grouped picks
extern "C" int pair(const float* a, const float* b, float* out, int m, int n,
                    int k, const float* ga, const float* gb, float* partial,
                    int gm, int gn, int gk, int grouped, void* stream) {
  const bool one = grouped < 0 ? pair_grouped(m, n, k) : grouped;
  return (int)launch_rows_and_grad(a, b, nullptr, out, m, n, k, ga, gb,
                                   partial, gm, gn, gk, one,
                                   (cudaStream_t)stream);
}
extern "C" int picks(int m, int n, int k) { return pair_grouped(m, n, k); }
extern "C" long long partial_floats(int gm, int gn, int gk) {
  return grad_sums_floats(gm, gn, gk);
}
extern "C" int sums(const float* partial, float* dw, float* db, int gm,
                    int gn, int gk, void* stream) {
  PartialSums s;
  add_grad_sums(s, partial, dw, db, gm, gn, gk);
  return (int)launch_reduce_sums(s, (cudaStream_t)stream);
}
"""
# (model, width C, tokens per clip) of every Swin stage
STAGES = (("swin-B", 128, 25088), ("swin-B", 256, 6272),
          ("swin-B", 512, 1568), ("swin-B", 1024, 392),
          ("swin-T", 96, 25088), ("swin-T", 192, 6272),
          ("swin-T", 384, 1568), ("swin-T", 768, 392))
MLP_BWD_TOL = 2e-5   # chip_smoke.py's
ROUNDS = 3           # of (two, one, one, two) timings, 50 calls each


def build():
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "pair.cu"
    src.write_text(PAIR_SOURCE)
    lib_path = out_dir / "libpair.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
           "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pair.argtypes = [p, p, p, i, i, i, p, p, p, i, i, i, i, p]
    lib.picks.argtypes = [i] * 3
    lib.partial_floats.argtypes = [i] * 3
    lib.partial_floats.restype = ctypes.c_longlong
    lib.sums.argtypes = [p, p, p, i, i, i, p]
    for fn in (lib.pair, lib.picks, lib.sums):
        fn.restype = i
    return lib


def event_ms(fn, reps: int = 50) -> float:
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


def scaled(name, got, want):
    err = float((got - want).abs().max())
    if not err <= MLP_BWD_TOL * float(want.abs().max()):
        raise AssertionError(f"{name}: error {err:.3e} of the largest value "
                             f"{float(want.abs().max()):.3e}")
    return err


def run_pair(lib, dev, gen, stream, what, m, c, k):
    """One pair: out (m, c) = a (m, k) b (k, c) beside dw (k, c) = a^T y
    and db = the column sums of a, y (m, c)."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    a, b, y = randn(m, k), randn(k, c, scale=k ** -0.5), randn(m, c)
    outs = {w: torch.empty(m, c, device=dev) for w in (0, 1)}
    parts = {w: torch.empty(lib.partial_floats(k, c, m), device=dev)
             for w in (0, 1)}

    def call(w):
        return lambda: lib.pair(a.data_ptr(), b.data_ptr(),
                                outs[w].data_ptr(), m, c, k, a.data_ptr(),
                                y.data_ptr(), parts[w].data_ptr(), k, c, m, w,
                                stream)
    for w in (0, 1):
        code = call(w)()
        if code != 0:
            raise RuntimeError(f"{what}: launch failed (CUDA error {code})")
    dw, db = torch.empty(k, c, device=dev), torch.empty(k, device=dev)
    if lib.sums(parts[1].data_ptr(), dw.data_ptr(), db.data_ptr(), k, c, m,
                stream) != 0:
        raise RuntimeError(f"{what}: the partial sums failed")
    torch.cuda.synchronize()
    if not (torch.equal(outs[0], outs[1]) and torch.equal(parts[0], parts[1])):
        raise AssertionError(f"{what}: one launch and two differ")
    err = max(scaled(f"{what} out", outs[1], a @ b),
              scaled(f"{what} dw", dw, a.t() @ y),
              scaled(f"{what} db", db, a.sum(0)))
    times = {0: [], 1: []}
    for w in (0, 1, 1, 0) * ROUNDS:
        times[w].append(event_ms(call(w)))
    two, one = statistics.median(times[0]), statistics.median(times[1])
    picked = "one" if lib.picks(m, c, k) else "two"
    gain = (two - one) / two * 100
    print(f"{what}: two launches {two:.4f} ms ({min(times[0]):.4f}-"
          f"{max(times[0]):.4f}), one launch {one:.4f} ms ({min(times[1]):.4f}"
          f"-{max(times[1]):.4f}), one against two {gain:+.1f}%, "
          f"pair_grouped picks {picked} (max abs err {err:.1e})", flush=True)
    return two, one


def main() -> int:
    if not torch.cuda.is_available():
        print("pair_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    lib = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for model, c, tokens in STAGES:
        m = 2 * tokens
        for name, k in (("g_att and dwproj", c), ("dx and dwqkv", 3 * c)):
            run_pair(lib, dev, gen, stream, f"{model} M={m} C={c}, {name}",
                     m, c, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
