"""Per-site device times of the bfloat16 packed attention, forward and
backward, at every Video Swin-B stage of the adapt batch (2 clips of
16 x 224 x 224), on the card.

    python3 -m vitta_tpu_torch.tools.attention_bf16_sites [rounds]

For each stage, with and without the shift mask where the stage has one,
and with the compact bias (the model's form at bfloat16) and the dense
one: the device ms of one call of the forward and of the backward
(``cuda_attention.attn_packed_{fwd,bwd}_cuda``), from CUDA events around
the replay of a CUDA graph of 5 calls, and ``scaled_dot_product_attention``
on the same values beside them (forward only: its backward does not
replay from outside its forward).  Each kernel's out and dqkv are first
held within 1e-2 of the largest value of the plain version's (the card
tests hold them to one ulp).  Ends with the sums over one Swin-B pass
(each stage's sites: every block, half of them shifted) in each of
``rounds`` rounds (default 2), the card's name and power limit beside
them.  With ``--sass`` it first prints each bfloat16 attention kernel's
instruction mix in the built library (``cuobjdump -sass``): its count of
instructions by opcode, the tensor-core products (HMMA) beside the rest.

    python3 -m vitta_tpu_torch.tools.attention_bf16_sites --dense \
        [--parent DIR] [rounds]

times the dense-bias forward per (head, window) instead (``dense_main``):
each build of ``DENSE_VARIANTS`` and, with ``--parent``, the attention
library built from another checkout's sources, in turns, at every Swin-T
and Swin-B stage.

    python3 -m vitta_tpu_torch.tools.attention_bf16_sites --dense-bwd \
        [--parent DIR ...] [rounds]

does the same for the dense-bias backward per (head, window), the kernel
and the windows' sum of dbias (``dense_bwd_main``: each build of
``DENSE_BWD_VARIANTS``, a copy of the source with a few edits, made under
``build/``): every build's dq, dk, dv and dbias the source's bits, the
parent's too.

    python3 -m vitta_tpu_torch.tools.attention_bf16_sites --proj-bwd \
        [--parent DIR ...] [rounds]

times rows 17 and 19 bf16, the projection-fused backward chains, at every
Swin-B stage (``proj_bwd_main``): each build of ``PROJ_BWD_VARIANTS`` and
each other checkout's, in turns, each with the source's bits.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

WINDOW = (8, 7, 7)
# (C, heads, tokens per clip, windows per clip, blocks) per stage
STAGES = ((128, 4, 25088, 64, 2), (256, 8, 6272, 16, 2),
          (512, 16, 1568, 4, 18), (1024, 32, 392, 1, 2))
CLIPS = 2


def graph_ms(fn, calls: int = 5, reps: int = 3) -> float:
    """Device ms a call of ``fn``: CUDA events around the replay of a CUDA
    graph of ``calls`` calls, the median of ``reps`` replays."""
    side = torch.cuda.Stream()
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
    return statistics.median(times)


def _close(name, got, want):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= 1e-2 * scale:
        raise AssertionError(f"{name}: max abs error {err:.3e} on values up "
                             f"to {scale:.3e}")


def sass_mix() -> None:
    """Print the instruction mix of the bfloat16 attention kernels of the
    built attention library (static counts, by opcode)."""
    import collections
    import re
    from pathlib import Path
    from vitta_tpu_torch.ops._build import build, find_nvcc
    lib = build("attention")
    tool = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0]
        if "bf16_kernel" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                part))
        total = sum(ops.values())
        print(f"{name[:80]}: {total} instructions, HMMA {ops['HMMA']} "
              f"({ops['HMMA'] / total:.1%}); "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(12)),
              flush=True)


# The dense forward's variants: name -> csrc/attention_kernels.cuh macros;
# the first is the source's own plan
DENSE_VARIANTS = {
    "the plan": {},
    "12 warps a block": {"VITTA_DENSE_FWD_MAX_WARPS": 12},
    "8 waves": {"VITTA_DENSE_FWD_WAVES": 8},
    "2 waves": {"VITTA_DENSE_FWD_WAVES": 2},
}
# (model, C, heads, windows per clip, blocks) of every Swin-T and Swin-B
# stage: the heads route's and the projection-fused routes' dense bias
DENSE_STAGES = (("swin-T", 96, 3, 64, 2), ("swin-T", 192, 6, 16, 2),
                ("swin-T", 384, 12, 4, 6), ("swin-T", 768, 24, 1, 2)) + tuple(
    ("swin-B", c, nh, tokens // 392, blocks)
    for c, nh, tokens, _nw, blocks in STAGES)


def _bind_heads(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.vitta_attn_heads_fwd_bf16.argtypes = [p, p, p, ll, p, p, p, p, i, i,
                                              i, i, i, ctypes.c_float, p, p]
    lib.vitta_attn_heads_fwd_bf16.restype = i
    return lib


def _build_parent(parent: str, tag: str = "parent",
                  source: str = "attention"):
    """The ``source`` library built from another checkout's csrc."""
    from pathlib import Path
    from vitta_tpu_torch.ops import _build
    src = Path(parent) / "vitta_tpu_torch" / "csrc" / f"{source}.cu"
    out = _build.BUILD_DIR / "variants" / f"lib{source}_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out)), "the parent's source"


def dense_main(rounds: int = 2, parent: str | None = None) -> int:
    """The dense-bias forward per (head, window) at every Swin-T and Swin-B
    stage of 2 clips, with and without the shift mask: each build of
    ``DENSE_VARIANTS`` (and, with ``parent``, the attention library built
    from that checkout's csrc) timed in turns by graph replays beside
    ``scaled_dot_product_attention``; every variant's out and ms the plan's
    bits, the plan's out within 1e-2 of the plain version's largest value
    and its e the dense backward's e bit for bit."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
    from vitta_tpu_torch.tools.gemm_variants import build
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    jobs = [(f"d{k}", name, macros)
            for k, (name, macros) in enumerate(DENSE_VARIANTS.items())]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        built = list(pool.map(lambda j: build("attention", j[0], j[2],
                                              "attn_fwd_dense_bf16_kernel"),
                              jobs))
        if parent is not None:
            built.append(_build_parent(parent))
            jobs.append(("parent", "parent", {}))
    libs = {}
    for (_tag, name, _m), (lib, info) in zip(jobs, built):
        print(f"{name}: {info}", flush=True)
        if lib is not None:
            libs[name] = _bind_heads(lib)
    wd, wh, ww = WINDOW
    n = wd * wh * ww
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for rnd in range(rounds):
        sums = {}
        for model, c, nh, windows, blocks in DENSE_STAGES:
            hd, scale = c // nh, (c // nh) ** -0.5
            b_ = CLIPS * windows
            dense = expand_bias_reference(torch.randn(
                nh, 2 * wd - 1, wh * ww, wh * ww, device=dev,
                generator=gen) * 0.5, wd)
            qkv = torch.randn(b_, n, 3 * c, device=dev,
                              generator=gen).to(torch.bfloat16)
            q, k, v = qkv.reshape(b_, n, 3, nh, hd).unbind(2)
            strides = (ctypes.c_longlong * 9)(*(
                st for t in (q, k, v) for st in t.stride()[:3]))
            masks = [None]
            if windows > 1:
                m = torch.where(torch.rand(windows, n, n, device=dev,
                                           generator=gen) < 0.3, -100.0, 0.0)
                m.diagonal(dim1=1, dim2=2).zero_()
                masks.append(m)
            for m in masks:
                sites = blocks // 2 if windows > 1 else blocks
                nw = windows if m is not None else 0
                plan = ca.dense_fwd_bf16_plan_cuda(b_, n, nh, nw, True)
                if plan != ca.dense_fwd_bf16_plan(
                        b_, n, nh, nw, True,
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count):
                    raise AssertionError(f"plan {plan} is not the mirror's")
                outs = {}

                def call(lib, out, ms, e_tap=None):
                    return lib.vitta_attn_heads_fwd_bf16(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
                        dense.data_ptr(),
                        None if m is None else m.data_ptr(), out.data_ptr(),
                        ms.data_ptr(), b_, n, nh, hd, max(nw, 1), scale,
                        None if e_tap is None else e_tap.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                line = [f"{model} B_={b_} nh={nh} mask={m is not None}: "
                        f"{plan['slots']} strips x {plan['bands']} bands, run "
                        f"{plan['run']}, "
                        f"{plan['blocks']} blocks"]
                for name, lib in libs.items():
                    out = torch.empty(b_, n, nh, hd, dtype=torch.bfloat16,
                                      device=dev)
                    ms = torch.empty(b_, n, 2 * nh, device=dev)
                    code = call(lib, out, ms)
                    torch.cuda.synchronize()
                    if code != 0:
                        line.append(f"{name}: CUDA error {code}")
                        continue
                    outs[name] = (out, ms)
                    if rnd == 0 and name == "the plan":
                        want, want_ms = ca.heads_attention_bf16_reference(
                            q, k, v, dense, m, scale, save_ms=True)
                        _close("out", out, want)
                        _close("ms", ms, want_ms)
                        e_f = torch.empty(b_, nh, n, n, dtype=torch.bfloat16,
                                          device=dev)
                        call(lib, torch.empty_like(out),
                             torch.empty_like(ms), e_f)
                        tb = {}
                        ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms,
                                               torch.randn_like(out), scale,
                                               taps=tb)
                        if not torch.equal(e_f, tb["e"]):
                            bad = (e_f != tb["e"]).float().mean().item()
                            raise AssertionError(
                                f"the forward's e is not the backward's: "
                                f"{bad:.2e} of values differ")
                        del want, want_ms, e_f, tb
                    elif not (torch.equal(out, outs["the plan"][0])
                              and torch.equal(ms, outs["the plan"][1])):
                        # another order of sums (the parent, another split)
                        _close(f"{name} out", out, outs["the plan"][0])
                        name = f"{name} (other bits)"
                    t = graph_ms(lambda: call(lib, out, ms))
                    sums[(model, name)] = sums.get((model, name), 0.0) + \
                        sites * t
                    line.append(f"{name} {t:.4f}")
                q5 = qkv.reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
                am = (dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        CLIPS, windows, nh, n, n).reshape(b_, nh, n, n)).to(
                            torch.bfloat16)
                t = graph_ms(lambda: F.scaled_dot_product_attention(
                    q5[0], q5[1], q5[2], attn_mask=am, scale=scale))
                sums[(model, "sdpa")] = sums.get((model, "sdpa"), 0.0) + \
                    sites * t
                line.append(f"sdpa {t:.4f}")
                print("  ".join(line), flush=True)
                del am, q5, outs
        for model in ("swin-T", "swin-B"):
            print(f"round {rnd}: device ms per {model} pass of {CLIPS} "
                  f"clips: " + ", ".join(f"{k[1]} {v:.4f}"
                                         for k, v in sums.items()
                                         if k[0] == model)
                  + f"; {card}", flush=True)
    return 0


# The dense backward's variants: name -> edits of the source's csrc, each
# (text, replacement), made in a copy under build/; the first is the source
DENSE_BWD_VARIANTS = {
    "the source": [],
    "reduce 8 windows ahead": [("constexpr int kReduceAhead = 4;",
                                "constexpr int kReduceAhead = 8;")],
    "reduce through L1": [("v[u] = __ldcs(dl +", "v[u] = __ldg(dl +")],
    "dl stored write-back": [("__stcs(dl_b + i * n + j, dl);",
                              "dl_b[i * n + j] = dl;")],
    # the next strip's bias and mask rows loaded at the strip's start into
    # a second buffer, as the compact form does (228,480 bytes at N = 392)
    "bias and mask double-buffered": [
        ("    nbuf = compact ? 2 : 1;", "    nbuf = 2;"),
        ("raw = spans = dls = bs + (size_t)16 * ldw * 4;",
         "raw = spans = dls = bs + (size_t)2 * 16 * ldw * 4;"),
        ("stage_rows(Bs, L.ldw, bias_h,",
         "stage_rows(Bs + buf * 16 * L.ldw, L.ldw, bias_h,"),
        ("const int wbuf = kCompact ? buf : 0;", "const int wbuf = buf;"),
        ("if (kCompact) load_bias(s + zs, buf ^ 1);",
         "load_bias(s + zs, buf ^ 1);"),
        ("if (!kCompact && next) load_bias(s + zs, 0);", ""),
        (": Bs + r * L.ldw + float_shift(",
         ": Bs + (wbuf * 16 + r) * L.ldw + float_shift(")],
}

# The projection-fused backward's variants, the same way
PROJ_BWD_VARIANTS = {
    "the source": [],
    # dbias summed on a stream of its own beside dx, the weight gradients
    # and the column sums, joined back before the call returns
    "dbias on a side stream": [
        ("    int compact, int wd, int hw, float scale, cudaStream_t stream) "
         "{\n  const long long c = (long long)nh * hd;",
         "    int compact, int wd, int hw, float scale, cudaStream_t stream,"
         "\n    bool sum_dense = true) {\n  const long long c = (long long)nh"
         " * hd;"),
        ("  } else {\n    return launch_dense_dbias_reduce(",
         "  } else if (sum_dense) {\n    return launch_dense_dbias_reduce("),
        ("    float scale, cudaStream_t stream) {\n  return launch_bwd_bf16(",
         "    float scale, cudaStream_t stream, bool sum_dense = true) {\n"
         "  return launch_bwd_bf16("),
        ("      mask, ms, dbias, scratch, e_tap, b_, n, nh, hd, nw, compact, "
         "wd, hw,\n      scale, stream);",
         "      mask, ms, dbias, scratch, e_tap, b_, n, nh, hd, nw, compact, "
         "wd, hw,\n      scale, stream, sum_dense);"),
        ("                                   scale, st);\n  if (e != "
         "cudaSuccess) return e;\n  // dx = bfloat16(dqkv wqkv)",
         "                                   scale, st, false);\n  if (e != "
         "cudaSuccess) return e;\n" + """\
  struct Side {
    cudaStream_t s = nullptr, st = nullptr;
    cudaEvent_t done = nullptr;
    ~Side() {
      if (s == nullptr) return;
      cudaEventRecord(done, s);
      cudaStreamWaitEvent(st, done, 0);
    }
  } side;
  {
    static cudaStream_t streams[64];
    static cudaEvent_t ready[64], dones[64];
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (streams[dev] == nullptr &&
        (cudaStreamCreateWithFlags(&streams[dev], cudaStreamNonBlocking) ||
         cudaEventCreateWithFlags(&ready[dev], cudaEventDisableTiming) ||
         cudaEventCreateWithFlags(&dones[dev], cudaEventDisableTiming)))
      return cudaErrorUnknown;
    e = cudaEventRecord(ready[dev], st);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(streams[dev], ready[dev], 0);
    if (e != cudaSuccess) return e;
    side.s = streams[dev], side.st = st, side.done = dones[dev];
  }
  e = attn::launch_dense_dbias_reduce(att, dbias, b_, n, nh, side.s);
  if (e != cudaSuccess) return e;
  // dx = bfloat16(dqkv wqkv)"""),
    ],
}


def _build_edited(tag: str, edits, source: str = "attention"):
    """The ``source`` library built from a copy of the source's csrc with
    ``edits`` made, each text found exactly once."""
    import shutil
    from vitta_tpu_torch.ops import _build
    root = _build.BUILD_DIR / "variants" / f"src_{tag}"
    csrc = root / "vitta_tpu_torch" / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    for text, repl in edits:
        hits = [f for f in csrc.iterdir() if text in f.read_text()]
        if len(hits) != 1 or hits[0].read_text().count(text) != 1:
            raise AssertionError(f"{tag}: {text!r} is not in one place")
        hits[0].write_text(hits[0].read_text().replace(text, repl))
    lib, _info = _build_parent(str(root), tag, source)
    return lib, f"the source with {len(edits)} edit(s)"


def _bind_heads_bwd(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.vitta_attn_heads_bwd_bf16.argtypes = [p, p, p, ll] + [p] * 9 + [
        i, i, i, i, i, ctypes.c_float, p, p]
    lib.vitta_attn_heads_bwd_bf16.restype = i
    lib.vitta_attn_bwd_bf16_scratch_floats.argtypes = [i] * 8
    lib.vitta_attn_bwd_bf16_scratch_floats.restype = ctypes.c_longlong
    return lib


def dense_bwd_main(rounds: int = 2, parents=()) -> int:
    """The dense-bias backward per (head, window) at every Swin-T and
    Swin-B stage of 2 clips, with and without the shift mask, from the
    row maxima and sums of the forward: each build of
    ``DENSE_BWD_VARIANTS`` (and the attention library built from each of
    ``parents``, other checkouts' csrc) timed in turns by graph replays, each
    with the scratch its own library asks for.  Every build gives the
    source's dq, dk, dv and dbias bit for bit (the parent's too: the same
    arithmetic and the same order of the windows' sum), and the source's
    dbias is its tapped dl added in window order
    (``cuda_attention.dbias_in_window_order``)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    jobs = [(f"b{k}", name, edits)
            for k, (name, edits) in enumerate(DENSE_BWD_VARIANTS.items())]
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        futures = [pool.submit(_build_edited, tag, edits)
                   for tag, _name, edits in jobs]
        for k, d in enumerate(parents):
            futures.append(pool.submit(_build_parent, d, f"p{k}"))
            jobs.append((f"p{k}", Path(d).name, []))
        built = [f.result() for f in futures]
    libs = {}
    for (_tag, name, _e), (lib, info) in zip(jobs, built):
        print(f"{name}: {info}", flush=True)
        libs[name] = _bind_heads_bwd(lib)
    wd, wh, ww = WINDOW
    n = wd * wh * ww
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    for rnd in range(rounds):
        sums = {}
        for model, c, nh, windows, blocks in DENSE_STAGES:
            hd, scale = c // nh, (c // nh) ** -0.5
            b_ = CLIPS * windows
            dense = expand_bias_reference(torch.randn(
                nh, 2 * wd - 1, wh * ww, wh * ww, device=dev,
                generator=gen) * 0.5, wd)
            qkv = torch.randn(b_, n, 3 * c, device=dev,
                              generator=gen).to(torch.bfloat16)
            q, k, v = qkv.reshape(b_, n, 3, nh, hd).unbind(2)
            g = torch.randn(b_, n, nh, hd, device=dev,
                            generator=gen).to(torch.bfloat16)
            strides = (ctypes.c_longlong * 9)(*(
                st for t in (q, k, v) for st in t.stride()[:3]))
            masks = [None]
            if windows > 1:
                m = torch.where(torch.rand(windows, n, n, device=dev,
                                           generator=gen) < 0.3, -100.0, 0.0)
                m.diagonal(dim1=1, dim2=2).zero_()
                masks.append(m)
            for m in masks:
                sites = blocks // 2 if windows > 1 else blocks
                nw = windows if m is not None else 0
                _o, ms = ca.attn_heads_fwd_cuda(q, k, v, dense, m, scale,
                                                save_ms=True)
                line = [f"{model} B_={b_} nh={nh} mask={m is not None}:"]
                bits = None
                for name, lib in libs.items():
                    outs = [torch.empty(b_, n, nh, hd, dtype=torch.bfloat16,
                                        device=dev) for _ in range(3)]
                    dbias = torch.empty_like(dense)
                    scratch = torch.empty(
                        lib.vitta_attn_bwd_bf16_scratch_floats(
                            b_, n, nh, hd, 0, 0, 0, 0), device=dev)

                    def call():
                        return lib.vitta_attn_heads_bwd_bf16(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            strides, dense.data_ptr(),
                            None if m is None else m.data_ptr(),
                            ms.data_ptr(), g.data_ptr(),
                            *(t.data_ptr() for t in outs), dbias.data_ptr(),
                            scratch.data_ptr(), b_, n, nh, hd, max(nw, 1),
                            scale, None,
                            torch.cuda.current_stream().cuda_stream)
                    code = call()
                    torch.cuda.synchronize()
                    if code != 0:
                        raise AssertionError(f"{name}: CUDA error {code}")
                    got = outs + [dbias]
                    if bits is None:
                        bits = [t.clone() for t in got]
                        if rnd == 0:
                            tb = {}
                            tapped = ca.attn_heads_bwd_cuda(
                                q, k, v, dense, m, ms, g, scale, taps=tb)
                            if not (all(torch.equal(p, r) for p, r in
                                        zip(tapped, bits)) and torch.equal(
                                    bits[3], ca.dbias_in_window_order(
                                        tb["dl"], dense))):
                                raise AssertionError(
                                    "the source's dbias is not its dl added "
                                    "in window order")
                            del tapped, tb
                    elif not all(torch.equal(p, r)
                                 for p, r in zip(got, bits)):
                        raise AssertionError(f"{name}: other bits than the "
                                             "source's")
                    t = graph_ms(call)
                    sums[(model, name)] = sums.get((model, name), 0.0) + \
                        sites * t
                    line.append(f"{name} {t:.4f}")
                print("  ".join(line), flush=True)
        for model in ("swin-T", "swin-B"):
            print(f"round {rnd}: device ms per {model} pass of {CLIPS} "
                  f"clips: " + ", ".join(f"{k[1]} {v:.4f}"
                                         for k, v in sums.items()
                                         if k[0] == model)
                  + f"; {card}", flush=True)
    return 0


def proj_bwd_main(rounds: int = 2, parents=()) -> int:
    """Rows 17 and 19 bf16: the projection-fused backward chains
    (``cuda_attention_proj.attn_proj_bwd`` / ``attn_ln_proj_bwd`` at
    bfloat16) at every Swin-B stage of 2 clips, with and without the shift
    mask: each build of ``PROJ_BWD_VARIANTS`` and of ``parents``' (other
    checkouts') attention_proj.cu in turns by graph replays, each giving
    the source's outputs bit for bit; the sums over one Swin-B pass."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path
    from vitta_tpu_torch.ops import _build
    from vitta_tpu_torch.ops import cuda_attention_proj as cp
    from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    names = list(PROJ_BWD_VARIANTS) + [Path(d).name for d in parents]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = [pool.submit(_build_edited, f"q{k}", edits,
                               "attention_proj")
                   for k, edits in enumerate(PROJ_BWD_VARIANTS.values())]
        futures += [pool.submit(_build_parent, d, f"p{k}", "attention_proj")
                    for k, d in enumerate(parents)]
        built = [f.result()[0] for f in futures]
    libs = {}
    loader = _build.load_library
    for name, lib in zip(names, built):
        _build.load_library = lambda _name, lib=lib: lib
        cp._LIB = None
        try:
            libs[name] = cp._lib()           # bound as the wrapper binds it
        finally:
            _build.load_library = loader
    cp._LIB = libs["the source"]
    wd, wh, ww = WINDOW
    n = wd * wh * ww
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    bf = lambda *shape, s=1.0: (torch.randn(
        *shape, device=dev, generator=gen) * s).to(torch.bfloat16)
    for rnd in range(rounds):
        sums = {}
        for c, nh, tokens, windows, blocks in STAGES:
            hd, scale = c // nh, (c // nh) ** -0.5
            b_ = CLIPS * tokens // n
            dense = expand_bias_reference(torch.randn(
                nh, 2 * wd - 1, wh * ww, wh * ww, device=dev,
                generator=gen) * 0.5, wd)
            x, g, gy = bf(b_, n, c), bf(b_, n, c), bf(b_, n, c)
            wqkv, bqkv = bf(3 * c, c, s=c ** -0.5), bf(3 * c, s=0.1)
            wproj, bproj = bf(c, c, s=c ** -0.5), bf(c, s=0.1)
            gamma = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            beta = 0.1 * torch.randn(c, device=dev, generator=gen)
            masks = [None]
            if windows > 1:
                m = torch.where(torch.rand(windows, n, n, device=dev,
                                           generator=gen) < 0.3, -100.0, 0.0)
                m.diagonal(dim1=1, dim2=2).zero_()
                masks.append(m)
            for m in masks:
                sites = blocks // 2 if windows > 1 else blocks
                _o, qkv, o_att, ms = cp.attn_proj_fwd(
                    x, wqkv, bqkv, wproj, bproj, dense, m, scale, nh,
                    save_residuals=True)
                _o, y, qkv_l, o_l, ms_l = cp.attn_ln_proj_fwd(
                    x, gamma, beta, 1e-5, wqkv, bqkv, wproj, bproj, dense, m,
                    scale, nh, save_residuals=True)
                calls = {
                    "attn_proj_bwd": lambda: cp.attn_proj_bwd(
                        x, qkv, wqkv, wproj, dense, m, o_att, ms, g, scale,
                        nh),
                    "attn_ln_proj_bwd": lambda: cp.attn_ln_proj_bwd(
                        x, y, qkv_l, gamma, 1e-5, wqkv, wproj, dense, m,
                        o_l, ms_l, g, gy, scale, nh)}
                for op, call in calls.items():
                    line = [f"{op} B_={b_} nh={nh} mask={m is not None}:"]
                    bits = None
                    for name, lib in libs.items():
                        cp._LIB = lib
                        got = call()
                        if bits is None:
                            bits = got
                        elif not all(torch.equal(p, r)
                                     for p, r in zip(got, bits)):
                            raise AssertionError(f"{op} {name}: other bits "
                                                 "than the source's")
                        t = graph_ms(call)
                        key = (op, name)
                        sums[key] = sums.get(key, 0.0) + sites * t
                        line.append(f"{name} {t:.4f}")
                    cp._LIB = libs["the source"]
                    print("  ".join(line), flush=True)
        for op in ("attn_proj_bwd", "attn_ln_proj_bwd"):
            print(f"round {rnd}: device ms of {op} bf16 per Swin-B pass of "
                  f"{CLIPS} clips: " + ", ".join(
                      f"{k[1]} {v:.4f}" for k, v in sums.items()
                      if k[0] == op) + f"; {card}", flush=True)
    return 0


def main(rounds: int = 2) -> int:
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops.cuda_bias import expand_bias_reference
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    wd, wh, ww = WINDOW
    n = wd * wh * ww
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for rnd in range(rounds):
        sums = {}
        for c, nh, tokens, nw, blocks in STAGES:
            hd, scale = c // nh, (c // nh) ** -0.5
            b_ = CLIPS * tokens // n
            vc = torch.randn(nh, 2 * wd - 1, wh * ww, wh * ww, device=dev,
                             generator=gen) * 0.5
            dense = expand_bias_reference(vc, wd)
            qkv = torch.randn(b_, n, 3 * c, device=dev,
                              generator=gen).to(torch.bfloat16)
            g = torch.randn(b_, n, c, device=dev,
                            generator=gen).to(torch.bfloat16)
            masks = [None]
            if nw > 1:
                m = torch.where(torch.rand(nw, n, n, device=dev,
                                           generator=gen) < 0.3, -100.0, 0.0)
                m.diagonal(dim1=1, dim2=2).zero_()
                masks.append(m)
            for m in masks:
                sites = blocks // 2 if nw > 1 else blocks
                out, ms = ca.attn_packed_fwd_cuda(qkv, vc, m, scale, nh,
                                                  save_ms=True)
                line = [f"B_={b_} nh={nh} mask={m is not None}"]
                if rnd == 0:
                    want, want_ms = ca.packed_attention_bf16_reference(
                        qkv, vc, m, scale, nh, save_ms=True)
                    _close("out", out, want)
                    for bias in (vc, dense):
                        got = ca.attn_packed_bwd_cuda(qkv, bias, m, ms, g,
                                                      scale, nh)
                        wq, wb = ca.packed_attention_bf16_backward_reference(
                            qkv, bias, m, ms, g, scale, nh)
                        _close("dqkv", got[0], wq)
                        _close("dbias", got[1], wb)
                        del got, wq, wb
                q5 = qkv.reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
                am = (dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n, n).reshape(b_, nh, n, n)).to(
                            torch.bfloat16)
                times = {
                    "fwd compact": graph_ms(lambda: ca.attn_packed_fwd_cuda(
                        qkv, vc, m, scale, nh)),
                    "fwd dense": graph_ms(lambda: ca.attn_packed_fwd_cuda(
                        qkv, dense, m, scale, nh)),
                    "sdpa": graph_ms(lambda: F.scaled_dot_product_attention(
                        q5[0], q5[1], q5[2], attn_mask=am, scale=scale)),
                    "bwd compact": graph_ms(lambda: ca.attn_packed_bwd_cuda(
                        qkv, vc, m, ms, g, scale, nh)),
                    "bwd dense": graph_ms(lambda: ca.attn_packed_bwd_cuda(
                        qkv, dense, m, ms, g, scale, nh))}
                for k, v in times.items():
                    sums[k] = sums.get(k, 0.0) + sites * v
                    line.append(f"{k} {v:.4f}")
                print("  ".join(line), flush=True)
                del am, q5
        print(f"round {rnd}: device ms per Swin-B pass of {CLIPS} clips: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sums.items())
              + f"; {card}", flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--sass" in args:
        args.remove("--sass")
        sass_mix()
    if "--dense-bwd" in args or "--proj-bwd" in args:
        main_ = dense_bwd_main if "--dense-bwd" in args else proj_bwd_main
        args = [a for a in args if a not in ("--dense-bwd", "--proj-bwd")]
        parents = []
        while "--parent" in args:
            at = args.index("--parent")
            parents.append(args[at + 1])
            del args[at:at + 2]
        sys.exit(main_(*(int(a) for a in args), parents=parents))
    if "--dense" in args:
        args.remove("--dense")
        parent = None
        if "--parent" in args:
            at = args.index("--parent")
            parent = args[at + 1]
            del args[at:at + 2]
        sys.exit(dense_main(*(int(a) for a in args), parent=parent))
    sys.exit(main(*(int(a) for a in args)))
