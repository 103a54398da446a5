"""Time gemm_tiles, the bfloat16 wgmma core and the attention forward at
other shapes, on the card.

    python3 -m vitta_tpu_torch.tools.gemm_variants          # all three
    python3 -m vitta_tpu_torch.tools.gemm_variants bf16     # the core only
    python3 -m vitta_tpu_torch.tools.gemm_variants bf16-mlp [--parent DIR
        ...] [rounds]

``bf16-mlp`` times the bfloat16 MLP without the LayerNorm (rows 8 and 9
bf16: ``vitta_mlp_{fwd,bwd}_bf16``, csrc/mlp_fused_bf16.cuh) at Video
Swin-T's stages 1 and 2: the forward with a and s and the backward at 2
clips, the eval forward without residuals at 1 clip, each by CUDA graphs'
replays, summed over a pass (two blocks a stage), in ``rounds`` turns (2 by
default; the order reversed every other round).  It builds csrc/mlp.cu
from the source, from each entry of ``MLP_BF16_VARIANTS`` (a copy of the
source's csrc under ``build/vitta_tpu_torch/variants/`` with a few text
edits; the shipped source has no switch for them) and, with ``--parent``,
from each ``DIR``'s ``vitta_tpu_torch/csrc`` (an unpacked checkout, e.g.
``git archive`` under ``build/``), all at once with ``-Xptxas -v``, and
prints each fused instance's registers and spills.  Every build's outputs
are checked before it is timed: o, a and s within one bfloat16 ulp of the
plain values on its own a, the gradients within 2^-7 of the largest value
of the plain backward's, two backward runs bit-equal; an ablation variant
(marked so) computes something else and only shows what a part costs.

The bfloat16 core (``csrc/gemm_wgmma_bf16.cuh``, the LayerNorm-MLP's six
products at bfloat16) fixes its ring's slots (``VITTA_WG_STAGES_128``, 4;
``VITTA_WG_STAGES_64``, 3), the sum of each 64-deep slice in fresh
accumulators (``VITTA_WG_PROMOTE``, 1), the tile (``VITTA_WG_TILE``: 0 the
plan's choice, or 64, 128, 256 for every row product), the row
products' chunks of K (``VITTA_WG_ROW_SPLIT``, 1), the weight
gradients' tile rows (``VITTA_WG_GRAD_TILE``, 128) and the exponential of
the GELU derivative's phi (``VITTA_WG_EXPF``, 0: ``__expf``).
``BF16_VARIANTS``
builds ``csrc/mlp.cu`` with other values; each of the six products
(``cuda_mlp.bf16_product_cuda`` on the variant's library) is checked at
every Swin-B stage shape of 2 clips and stage 3's of 1 clip (the eval
forward) against the float32 product of the same bfloat16 values
(bfloat16 outputs within one ulp or 2^-20 of the largest, float32 ones to
2e-5 of the largest; a variant outside is reported, not timed) and timed
by CUDA graphs' replays (``graph_ms``), in turns, beside ``torch.matmul``
at bfloat16.

``csrc/gemm_tiles.cuh`` fixes the matrix product's k depth per staged
slice (``VITTA_GEMM_BK``, 32), the number of slices in its cp.async ring
(``VITTA_GEMM_STAGES``, 3) and the k steps summed in one fresh accumulator
(``VITTA_GEMM_FRESH``, 4); ``csrc/attention_kernels.cuh`` fixes the
attention forward's warps per block (``VITTA_ATTN_FWD_WARPS``, 16) and keys
per chunk (``VITTA_ATTN_FWD_KEYS``, 32).  This script builds
``csrc/mlp.cu`` once per entry of ``GEMM_VARIANTS`` and
``csrc/attention.cu`` once per entry of ``FWD_VARIANTS``, all at once, with
``nvcc -Xptxas -v``, prints each kernel's registers and spills, checks
every build against the plain version, and prints CUDA-event times:

* the MLP without the LayerNorm (two products forward: x w1^T with the
  GELU, a w2^T; four backward: (g w2) * s, dh w1, dh^T x, g^T a) at every
  Swin-B and Swin-T stage shape of 2 clips, as float32-equivalent TFLOP/s
  (2MNK over the call's time), beside ``torch.matmul`` (TF32 off) on the
  same products;
* the packed attention forward at every Swin-B and Swin-T stage shape of 2
  clips (with the shift mask where the stage has one) and Swin-B's last
  stage at 1 clip, beside ``scaled_dot_product_attention``.

First it times the tensor cores' own rate under ``mma.sync``: a kernel
that issues nothing but independent ``mma.sync.m16n8k8`` tf32 products on
register operands (``ROOF_SOURCE``), the ceiling of any split-TF32 kernel
built on that instruction (a third of it in float32-equivalent terms).
A variant that does not build, or does not launch (more shared memory than
a block may have), is reported and left out.  Needs a CUDA device and nvcc;
the libraries go to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops import _build
from vitta_tpu_torch.ops import cuda_attention as ca
from vitta_tpu_torch.ops import cuda_bias as cb
from vitta_tpu_torch.ops import cuda_mlp as cm
from vitta_tpu_torch.ops._launch import raise_on

# name -> macro values; the first of each is the source's own
GEMM_VARIANTS = {
    "BK 32, 3 stages, fresh sums of 4 steps": {},
    "fresh sums of 1 step": {"VITTA_GEMM_FRESH": 1},
    "fresh sums of 2 steps": {"VITTA_GEMM_FRESH": 2},
    "4 stages": {"VITTA_GEMM_STAGES": 4},
    "BK 16, fresh sums of 2 steps": {"VITTA_GEMM_BK": 16,
                                     "VITTA_GEMM_FRESH": 2},
}
BF16_VARIANTS = {
    "the plan (4 / 3 slots, promotion)": {},
    "promotion off": {"VITTA_WG_PROMOTE": 0},
    "128 x 128 tiles": {"VITTA_WG_TILE": 128},
    "64 x 128 tiles": {"VITTA_WG_TILE": 64},
    "128 x 256 tiles, promotion off": {"VITTA_WG_TILE": 256,
                                       "VITTA_WG_PROMOTE": 0},
    "3 slots at 128 rows": {"VITTA_WG_STAGES_128": 3},
    "2 slots at 64 rows": {"VITTA_WG_STAGES_64": 2},
    "4 slots at 64 rows (one block a SM)": {"VITTA_WG_STAGES_64": 4},
    "row products in 2 chunks of K": {"VITTA_WG_ROW_SPLIT": 2},
    "weight gradients at 64 rows": {"VITTA_WG_GRAD_TILE": 64},
    "expf for the GELU derivative's phi": {"VITTA_WG_EXPF": 1},
}
# (M, C) of Swin-B's stages at 2 clips, and stage 3 at 1 clip (the eval
# forward)
BF16_SHAPES = ((50176, 128), (12544, 256), (3136, 512), (1568, 512),
               (784, 1024))
FWD_VARIANTS = {
    "16 warps, 32 keys": {},
    "8 warps": {"VITTA_ATTN_FWD_WARPS": 8},
    "16 keys": {"VITTA_ATTN_FWD_KEYS": 16},
}
# (model, width C) of every Swin stage, tokens per clip per stage
MLP_SHAPES = (("swin-B", 128), ("swin-B", 256), ("swin-B", 512),
              ("swin-B", 1024), ("swin-T", 96), ("swin-T", 192),
              ("swin-T", 384), ("swin-T", 768))
TOKENS = (25088, 6272, 1568, 392)
# attention stages: model, width, heads, windows per clip, mask windows (0:
# no mask), clips; Swin-B's last stage also for 1 clip
ATTN_STAGES = (("swin-B", 128, 4, 64, 64, 2), ("swin-B", 256, 8, 16, 16, 2),
               ("swin-B", 512, 16, 4, 4, 2), ("swin-B", 1024, 32, 1, 0, 2),
               ("swin-B", 1024, 32, 1, 0, 1), ("swin-T", 96, 3, 64, 64, 2),
               ("swin-T", 192, 6, 16, 16, 2), ("swin-T", 384, 12, 4, 4, 2),
               ("swin-T", 768, 24, 1, 0, 2))
WD, HW = 8, 49
ROOF_SOURCE = r"""
#include "tf32.cuh"
// kChains independent accumulators a warp, mma.sync on register operands:
// the rate of the tensor cores under mma.sync, nothing else in the loop
constexpr int kChains = 8;
__global__ void mma_roof(float* out, int iters) {
  unsigned a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = 0x3f800000u + threadIdx.x + e;
  b[0] = 0x3f800000u + threadIdx.x, b[1] = b[0] + 7;
  float acc[kChains][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < kChains; ++j) vitta::mma_tf32(acc[j], a, b);
  float s = 0.f;
  for (int j = 0; j < kChains; ++j) s += acc[j][0] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int roof(float* out, int blocks, int threads, int iters,
                    void* stream) {
  mma_roof<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
ROOF_CHAINS = 8
MLP_TOL, MLP_BWD_TOL, ATTN_TOL = 1e-4, 2e-5, 2e-5   # chip_smoke.py's


def build(source: str, tag: str, macros: dict, kernel: str):
    """(library, ptxas summary) of the variant, or (None, nvcc's error)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{source}_{tag}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{k}={v}" for k, v in macros.items()),
           "-o", str(out), str(_build.CSRC_DIR / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        return None, f"nvcc failed:\n{proc.stderr[-3000:]}"
    lines = proc.stderr.splitlines()
    info = []
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            name = re.search(r"'(\S+)'", line)
            args = re.search(rf"{kernel}(I\S*?E)v", name.group(1) if name
                             else "")
            used = " ".join(lines[k + 1:k + 4]).replace("ptxas info    :", "")
            regs = re.search(r"Used (\d+) registers", used)
            spill = re.search(r"(\d+) bytes spill stores", used)
            frame = re.search(r"(\d+) bytes stack frame", used)
            info.append(f"{kernel}{args.group(1) if args else ''}: "
                        f"{regs.group(1) if regs else '?'} registers, "
                        f"{spill.group(1) if spill else '?'} bytes spilled, "
                        f"{frame.group(1) if frame else '?'} bytes of stack")
    return ctypes.CDLL(str(out)), "; ".join(info)


def mma_roof(dev, stream) -> str:
    """TFLOP/s of tf32 mma.sync.m16n8k8 alone (2 x 16 x 8 x 8 operations
    each), over every SM at 4 blocks of 8 warps."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_roof.cu"
    src.write_text(ROOF_SOURCE)
    lib_path = out_dir / "libmma_roof.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
           "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        return f"does not build:\n{proc.stderr[-2000:]}"
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.roof.argtypes = [p, i, i, i, p]
    lib.roof.restype = i
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    threads, iters = 256, 4096
    out = torch.empty(blocks * threads, device=dev)
    ms = event_ms(lambda: lib.roof(out.data_ptr(), blocks, threads, iters,
                                   stream))
    flops = blocks * threads // 32 * iters * ROOF_CHAINS * 2 * 16 * 8 * 8
    rate = flops / ms / 1e9
    return (f"{rate:.1f} TFLOP/s tf32 ({rate / 3:.1f} float32-equivalent in "
            f"split TF32) over {blocks} blocks of {threads} threads")


def bind(lib, source: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if source == "mlp_bf16":
        lib.vitta_lnmlp_bf16_product.argtypes = [i] + [p] * 8 + [i, i, i, p]
        lib.vitta_lnmlp_bf16_product.restype = i
        lib.vitta_lnmlp_bf16_product_scratch_floats.argtypes = [i, i, i, i]
        lib.vitta_lnmlp_bf16_product_scratch_floats.restype = \
            ctypes.c_longlong
    elif source == "mlp":
        lib.vitta_mlp_fwd.argtypes = [p] * 8 + [i, i, i, p]
        lib.vitta_mlp_fwd.restype = i
        lib.vitta_mlp_bwd.argtypes = [p] * 12 + [i, i, i, p]
        lib.vitta_mlp_bwd.restype = i
        lib.vitta_mlp_bwd_scratch_floats.argtypes = [i, i, i]
        lib.vitta_mlp_bwd_scratch_floats.restype = ctypes.c_longlong
    else:
        lib.vitta_attn_packed_fwd.argtypes = [p] * 5 + [i] * 8 + [
            ctypes.c_float, p]
        lib.vitta_attn_packed_fwd.restype = i
    return lib


def event_ms(fn, reps: int = 10) -> float:
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


_SIDE_STREAM = []


def graph_ms(fn, calls: int = 5, reps: int = 5) -> float:
    """Device ms per call of ``fn`` from CUDA events around the replay of a
    CUDA graph of ``calls`` calls (median of ``reps`` replays): the
    kernels back to back, no host in between (chip_smoke.py's way)."""
    if not _SIDE_STREAM:    # one for every call: torch keeps a cuBLAS
        _SIDE_STREAM.append(torch.cuda.Stream())   # workspace a stream
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
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
    del graph
    return sorted(times)[len(times) // 2]


def close(name, got, want, tol):
    """Max abs error; raises unless |got - want| <= tol + tol |want|."""
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max()):.3e}")
    return float(err.max())


def scaled(name, got, want, tol):
    """Max abs error; raises unless it is at most tol of want's largest
    magnitude."""
    err = float((got - want).abs().max())
    if not err <= tol * float(want.abs().max()):
        raise AssertionError(f"{name}: error {err:.3e} of the largest value "
                             f"{float(want.abs().max()):.3e}")
    return err


def run_mlp(libs, dev, gen, stream):
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    for (model, c), tokens in zip(MLP_SHAPES, TOKENS * 2):
        m, f = 2 * tokens, 4 * c
        x, g = randn(m, c, scale=1.5), randn(m, c)
        w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
        w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
        o_ref, a_ref, s_ref = cm.mlp_reference(x, w1, b1, w2, b2, True)
        want = cm.mlp_backward_reference(x, a_ref, s_ref, g, w1, w2)
        fwd_fl, bwd_fl = 4 * m * c * f, 8 * m * c * f
        lib_f = event_ms(lambda: (torch.matmul(x, w1.t()),
                                  torch.matmul(a_ref, w2.t())))
        lib_b = event_ms(lambda: (torch.matmul(g, w2), torch.matmul(a_ref, w1),
                                  torch.matmul(a_ref.t(), x),
                                  torch.matmul(g.t(), a_ref)))
        print(f"{model} M={m} C={c} F={f}: torch.matmul (TF32 off) forward "
              f"{lib_f:.3f} ms, {fwd_fl / lib_f / 1e9:.1f} TFLOP/s; backward "
              f"{lib_b:.3f} ms, {bwd_fl / lib_b / 1e9:.1f} TFLOP/s", flush=True)
        o, a, s = (torch.empty_like(t) for t in (o_ref, a_ref, s_ref))
        grads = [torch.empty_like(t) for t in want]
        for name, lib in libs.items():
            scratch = torch.empty(lib.vitta_mlp_bwd_scratch_floats(m, c, f),
                                  device=dev)

            def fwd():
                return lib.vitta_mlp_fwd(
                    x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), a.data_ptr(), s.data_ptr(), o.data_ptr(),
                    m, c, f, stream)

            def bwd():
                return lib.vitta_mlp_bwd(
                    x.data_ptr(), a_ref.data_ptr(), s_ref.data_ptr(),
                    g.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                    *(t.data_ptr() for t in grads), scratch.data_ptr(), m, c,
                    f, stream)
            code = fwd() or bwd()
            if code != 0:
                print(f"  {name}: does not launch (CUDA error {code})",
                      flush=True)
                continue
            torch.cuda.synchronize()
            try:
                err = max(close(f"{name} {nm}", got, ref, MLP_TOL)
                          for nm, got, ref in (("o", o, o_ref),
                                               ("a", a, a_ref),
                                               ("s", s, s_ref)))
                err_b = max(scaled(f"{name} {nm}", got, ref, MLP_BWD_TOL)
                            for nm, got, ref in zip(
                                ("dx", "dw1", "db1", "dw2", "db2"), grads,
                                want))
            except AssertionError as e:
                print(f"  {name}: fails the tolerance: {e}", flush=True)
                continue
            tf, tb = event_ms(fwd), event_ms(bwd)
            print(f"  {name}: forward {tf:.3f} ms, {fwd_fl / tf / 1e9:.1f} "
                  f"TFLOP/s; backward {tb:.3f} ms, {bwd_fl / tb / 1e9:.1f} "
                  f"TFLOP/s (max abs err {err:.1e}, backward {err_b:.1e})",
                  flush=True)
            del scratch
        del x, g, o_ref, a_ref, s_ref, want, o, a, s, grads


def run_bf16(libs, dev, gen):
    """Each of the six bfloat16 products by every variant at BF16_SHAPES:
    checked against the float32 product, then timed; the row-split variant
    only where it cuts K (o and dy, and h and dh where K = C allows)."""
    from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
    bf16 = torch.bfloat16

    def bf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(bf16)

    for m, c in BF16_SHAPES:
        f = 4 * c
        y, w1, b1 = bf(m, c), bf(f, c, scale=c ** -0.5), bf(f, scale=0.1)
        a, w2, b2 = bf(m, f), bf(c, f, scale=f ** -0.5), bf(c, scale=0.1)
        go, s_, gy, dhc = bf(m, c), bf(m, f), bf(m, c, scale=0.1), bf(m, f)
        f32 = lambda t: t.float()
        h = f32(y) @ f32(w1).t() + f32(b1)
        calls = {   # name: (operands, bias, aux, want, torch.matmul)
            "h": ((y, w1), b1, None, (F.gelu(h).to(bf16),
                                      cm.gelu_derivative(h).to(bf16)),
                  lambda: y @ w1.t()),
            "o": ((a, w2), b2, None,
                  (f32(a) @ f32(w2).t() + f32(b2)).to(bf16),
                  lambda: a @ w2.t()),
            "dh": ((go, w2), None, s_, ((f32(go) @ f32(w2)) * f32(s_), None),
                   lambda: go @ w2),
            "dy": ((dhc, w1), None, gy, f32(dhc) @ f32(w1) + f32(gy),
                   lambda: dhc @ w1),
            "dw1": ((dhc, y), None, None, (f32(dhc).t() @ f32(y)).to(bf16),
                    lambda: dhc.t() @ y),
            "dw2": ((go, a), None, None, (f32(go).t() @ f32(a)).to(bf16),
                    lambda: go.t() @ a)}
        flops = 2 * m * c * f
        for name, (ops, bias, aux, want, mm) in calls.items():
            line = [f"torch.matmul {flops / graph_ms(mm) / 1e9:.1f}"]
            for variant, lib in libs.items():
                run = lambda: cm.bf16_product_cuda(name, *ops, bias=bias,
                                                   aux=aux, lib=lib)
                try:
                    got = run()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    line.append(f"{variant}: does not launch ({e})")
                    continue
                try:
                    gots = got if isinstance(got, tuple) else (got,)
                    wants = want if isinstance(want, tuple) else (want,)
                    for k, (g_, w_) in enumerate(zip(gots, wants)):
                        if w_ is None:
                            continue
                        if w_.dtype == bf16:
                            assert_bf16_within(f"{name}[{k}]", g_, w_)
                        else:
                            scaled(f"{name}[{k}]", g_, w_, 2e-5)
                except AssertionError as e:
                    line.append(f"{variant}: fails the check ({e})")
                    continue
                line.append(f"{variant} {flops / graph_ms(run) / 1e9:.1f}")
            print(f"bf16 {name} M={m} C={c} F={f}, TFLOP/s: "
                  + "; ".join(line), flush=True)
        del y, w1, b1, a, w2, b2, go, s_, gy, dhc, calls


def run_attention(libs, dev, gen, stream):
    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    n = WD * HW
    for model, c, nh, windows, nw, clips in ATTN_STAGES:
        hd, b_ = c // nh, clips * windows
        scale = hd ** -0.5
        qkv = randn(b_, n, 3 * c)
        dense = cb.expand_bias_reference(randn(nh, 2 * WD - 1, HW, HW), WD)
        mask = None
        if nw:
            mask = torch.where(torch.rand(nw, n, n, device=dev, generator=gen)
                               < 0.3, -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        want, want_ms = ca.packed_attention_reference(qkv, dense, mask, scale,
                                                      nh, save_ms=True)
        q5 = qkv.reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        am = dense[None] if mask is None else (
            dense[None, None] + mask[None, :, None]).expand(
                b_ // nw, nw, nh, n, n).reshape(b_, nh, n, n)
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            q5[0], q5[1], q5[2], attn_mask=am, scale=scale))
        print(f"{model} attention B_={b_} nh={nh} N={n} mask="
              f"{mask is not None}: "
              f"sdpa {sdpa:.3f} ms; forward by variant:", flush=True)
        out, ms = torch.empty_like(want), torch.empty_like(want_ms)
        for name, lib in libs.items():
            def run():
                return lib.vitta_attn_packed_fwd(
                    qkv.data_ptr(), dense.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    ms.data_ptr(), b_, n, nh, hd, max(nw, 1), 0, WD, HW,
                    scale, stream)
            code = run()
            if code != 0:
                print(f"  {name}: does not launch (CUDA error {code})",
                      flush=True)
                continue
            torch.cuda.synchronize()
            try:
                err = max(close(f"{name} out", out, want, ATTN_TOL),
                          close(f"{name} ms", ms, want_ms, ATTN_TOL))
            except AssertionError as e:
                print(f"  {name}: fails the tolerance: {e}", flush=True)
                continue
            print(f"  {name}: {event_ms(run):.3f} ms (max abs err "
                  f"{err:.1e})", flush=True)
        del qkv, dense, mask, want, want_ms, am, out, ms


# The fused MLP's variants: name -> edits of a copy of the source's csrc,
# each (text, replacement) found exactly once; the first is the source.
_GELU = ("gelu_parts_bf16(h0, a0, s0);\n"
         "        gelu_parts_bf16(h1, a1, s1);")
# The fused MLP's variants: name -> edits of a copy of the source's csrc,
# each (text, replacement) found exactly once; the first is the source.
# An ablation computes something else: it shows what a part costs.
_GELU = ("gelu_parts_bf16(h0, a0, s0);\n"
         "        gelu_parts_bf16(h1, a1, s1);")
MLP_BF16_VARIANTS = {
    "the source": [],
    "ablation: no GELU (a = s = h)": [
        (_GELU, "a0 = s0 = h0;\n        a1 = s1 = h1;"),
        ("        a0 = h0 * (0.5f * (1.0f + erff(h0 * 0.7071067811865476f)));\n"
         "        a1 = h1 * (0.5f * (1.0f + erff(h1 * 0.7071067811865476f)));",
         "        a0 = h0;\n        a1 = h1;")],
    "ablation: no TMA stores of a, s, dhc": [
        ("if (t == 0 && x.live && p.residuals) {", "if (false) {"),
        ("if (t == 0 && x.live) {\n      tma_store(x.mf2, buf, col0, x.m0);",
         "if (false) {\n      tma_store(x.mf2, buf, col0, x.m0);")],
    "ablation: no weight gradients": [
        ("  e = wgmma_grads(g1, &g2, st);\n  if (e != cudaSuccess) return e;\n"
         "  PartialSums sums;",
         "  PartialSums sums;")],
    "ablation: no ordered reduce": [
        ("gr->plan.splits, (long long)gr->M * gr->N);\n"
         "  return launch_reduce_sums(sums, st);",
         "gr->plan.splits, (long long)gr->M * gr->N);\n"
         "  return cudaSuccess;")],
}
# Swin-T's stages 1 and 2: width, tokens a clip, blocks
MLP_BF16_STAGES = ((96, 25088, 2), (192, 6272, 2))


def _edited_csrc(tag: str, edits) -> str:
    """A copy of the source's csrc with ``edits`` made, each text found
    exactly once; returns the root that holds vitta_tpu_torch/csrc."""
    import shutil
    root = _build.BUILD_DIR / "variants" / f"src_{tag}"
    csrc = root / "vitta_tpu_torch" / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    for text, repl in edits:
        hits = [f for f in csrc.iterdir() if text in f.read_text()]
        if len(hits) != 1 or hits[0].read_text().count(text) != 1:
            raise AssertionError(f"{tag}: {text!r} is not in one place")
        hits[0].write_text(hits[0].read_text().replace(text, repl))
    return str(root)


def _build_mlp(root: str, tag: str):
    """(library, ptxas summary of the fused instances) of csrc/mlp.cu under
    ``root``, or (None, nvcc's error)."""
    from pathlib import Path
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libmlp_{tag}.so"
    src = Path(root) / "vitta_tpu_torch" / "csrc" / "mlp.cu"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return None, f"nvcc failed:\n{proc.stderr[-3000:]}"
    lines, info = proc.stderr.splitlines(), []
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "mlp_rows_bf16" in line:
            name = re.search(r"mlp_rows_bf16ILi(\d+)ELb(\d)E", line)
            used = " ".join(lines[k + 1:k + 4])
            regs = re.search(r"Used (\d+) registers", used)
            spill = re.search(r"(\d+) bytes spill stores", used)
            kind = "bwd" if name.group(2) == "1" else "fwd"
            info.append(f"<{name.group(1)}, {kind}>: "
                        f"{regs.group(1) if regs else '?'} registers at "
                        f"launch, {spill.group(1) if spill else '?'} bytes "
                        f"spilled")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vitta_mlp_fwd_bf16.argtypes = [p] * 8 + [i, i, i, p]
    lib.vitta_mlp_fwd_bf16.restype = i
    lib.vitta_mlp_bwd_bf16.argtypes = [p] * 13 + [i, i, i, p]
    lib.vitta_mlp_bwd_bf16.restype = i
    lib.vitta_mlp_bwd_bf16_scratch_floats.argtypes = [i, i, i]
    lib.vitta_mlp_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
    return lib, "; ".join(info) or "no fused instance"


def _mlp_bf16_calls(lib, x, w1, b1, w2, b2, g, a, s):
    """(forward with residuals, eval forward, backward) of ``lib`` on these
    tensors on the current stream (a graph's capture's, when captured),
    each returning its outputs; a library without the fused kernels (an
    older build) is handed an (M, F) buffer for a always."""
    m, c = x.shape
    f = w1.shape[0]
    dev, bf16 = x.device, torch.bfloat16
    fused = (hasattr(lib, "vitta_mlp_bf16_rows_plan")
             and cm.mlp_bf16_fused(c, f))
    o = torch.empty_like(x)
    a_out, s_out = torch.empty((m, f), dtype=bf16, device=dev), \
        torch.empty((m, f), dtype=bf16, device=dev)
    a_eval = None if fused else a_out
    new = lambda *shape: torch.empty(shape, dtype=bf16, device=dev)
    grads = (new(m, c), new(f, c), new(f), new(c, f), new(c))
    scratch = torch.empty(lib.vitta_mlp_bwd_bf16_scratch_floats(m, c, f),
                          dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()

    def fwd(res=True):
        raise_on(lib.vitta_mlp_fwd_bf16(
            ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(b2),
            ptr(a_out if res else a_eval), ptr(s_out if res else None),
            ptr(o), m, c, f, torch.cuda.current_stream().cuda_stream),
            "forward")
        return (o, a_out, s_out) if res else o

    def bwd():
        raise_on(lib.vitta_mlp_bwd_bf16(
            ptr(x), ptr(a), ptr(s), ptr(g), ptr(w1), ptr(w2),
            *(ptr(t) for t in grads), ptr(scratch), None, m, c, f,
            torch.cuda.current_stream().cuda_stream), "backward")
        return grads
    return fwd, lambda: fwd(False), bwd


def mlp_bf16_main(rounds: int = 2, parents=()) -> int:
    """Rows 8 and 9 bf16 by every build, in turns (see the module's
    docstring)."""
    from pathlib import Path
    from vitta_tpu_torch.tools.bf16_checks import (assert_bf16_within,
                                                   mlp_fwd_stages)
    dev = torch.device("cuda")
    roots = {name: (_edited_csrc(f"m{k}", edits) if edits
                    else str(_build.CSRC_DIR.parents[1]))
             for k, (name, edits) in enumerate(MLP_BF16_VARIANTS.items())}
    roots.update({f"parent {Path(d).name}": d for d in parents})
    with ThreadPoolExecutor(max_workers=len(roots)) as pool:
        built = dict(zip(roots, pool.map(
            lambda kv: _build_mlp(kv[1], f"b{list(roots).index(kv[0])}"),
            roots.items())))
    libs = {}
    for name, (lib, info) in built.items():
        print(f"mlp bf16, {name}: {info}", flush=True)
        if lib is not None:
            libs[name] = lib
    gen = torch.Generator(device=dev).manual_seed(20)

    def bf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(torch.bfloat16)

    totals = {name: {"fwd": [0.0] * rounds, "bwd": [0.0] * rounds,
                     "eval": [0.0] * rounds} for name in libs}
    for c, tokens, depth in MLP_BF16_STAGES:
        f = 4 * c
        w1, b1 = bf(f, c, scale=c ** -0.5), bf(f, scale=0.1)
        w2, b2 = bf(c, f, scale=f ** -0.5), bf(c, scale=0.1)
        x, g = bf(2 * tokens, c), bf(2 * tokens, c)
        a, s_ = cm.mlp_bf16_reference(x, w1, b1, w2, b2, True)[1:]
        want = cm.mlp_bf16_backward_reference(x, a, s_, g, w1, w2)
        x1 = x[:tokens]
        calls, bad = {}, {}
        for name, lib in libs.items():
            fwd, _ev, bwd = _mlp_bf16_calls(lib, x, w1, b1, w2, b2, g, a, s_)
            _fw, ev, _bw = _mlp_bf16_calls(lib, x1, w1, b1, w2, b2, g, a, s_)
            calls[name] = {"fwd": fwd, "eval": ev, "bwd": bwd}
            try:
                got = fwd()
                for nm, p_, q_ in zip("oas", got, mlp_fwd_stages(
                        x, w1, b1, w2, b2, got[1])):
                    assert_bf16_within(f"{name} {nm}", p_, q_)
                one = [t.clone() for t in bwd()]
                for nm, p_, q_ in zip(("dx", "dw1", "db1", "dw2", "db2"),
                                      one, want):
                    scaled(f"{name} {nm}", p_.float(), q_.float(), 2 ** -7)
                if not all(torch.equal(p_, q_) for p_, q_ in zip(one, bwd())):
                    raise AssertionError("two backward runs differ")
                torch.cuda.synchronize()
            except (AssertionError, RuntimeError) as e:
                bad[name] = str(e).splitlines()[0][:160]
        for r in range(rounds):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for name in order:
                for kind, fn in calls[name].items():
                    totals[name][kind][r] += depth * graph_ms(fn)
        for name in libs:
            note = f" ({bad[name]})" if name in bad else ""
            print(f"mlp bf16 C={c}: {name}{note}", flush=True)
        del x, g, a, s_, want, calls, x1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for name, t in totals.items():
        print(f"mlp bf16 per Swin-T pass ({card}; device ms by graph "
              f"replays, in turns): {name}: forward (2 clips, a and s) "
              + ", ".join(f"{v:.4f}" for v in t["fwd"]) + "; backward "
              + ", ".join(f"{v:.4f}" for v in t["bwd"])
              + "; eval forward (1 clip) "
              + ", ".join(f"{v:.4f}" for v in t["eval"]), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    if sys.argv[1:2] == ["bf16-mlp"]:
        args, parents = sys.argv[2:], []
        while "--parent" in args:
            at = args.index("--parent")
            parents.append(args[at + 1])
            del args[at:at + 2]
        return mlp_bf16_main(*(int(a) for a in args), parents=parents)
    only_bf16 = sys.argv[1:] == ["bf16"]
    jobs = [("mlp_bf16", f"w{k}", name, macros, "gemm_wgmma_bf16")
            for k, (name, macros) in enumerate(BF16_VARIANTS.items())]
    if not only_bf16:
        jobs += [("mlp", f"g{k}", name, macros, "gemm_tiles")
                 for k, (name, macros) in enumerate(GEMM_VARIANTS.items())]
        jobs += [("attention", f"f{k}", name, macros, "attn_fwd_kernel")
                 for k, (name, macros) in enumerate(FWD_VARIANTS.items())]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(
            lambda j: build(j[0].replace("_bf16", ""), j[1], j[3], j[4]),
            jobs))
    libs = {"mlp_bf16": {}, "mlp": {}, "attention": {}}
    for (source, _tag, name, _macros, _k), (lib, info) in zip(jobs, built):
        print(f"{source}, {name}: {info}", flush=True)
        if lib is not None:
            libs[source][name] = bind(lib, source)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    run_bf16(libs["mlp_bf16"], dev, gen)
    if not only_bf16:
        print(f"mma.sync tf32 alone: {mma_roof(dev, stream)}", flush=True)
        run_attention(libs["attention"], dev, gen, stream)
        run_mlp(libs["mlp"], dev, gen, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
