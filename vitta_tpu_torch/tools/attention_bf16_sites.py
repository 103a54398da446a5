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
and Swin-B stage.  Needs a CUDA device and nvcc.
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


def dense_main(rounds: int = 2, parent: str | None = None) -> int:
    """The dense-bias forward per (head, window) at every Swin-T and Swin-B
    stage of 2 clips, with and without the shift mask: each build of
    ``DENSE_VARIANTS`` (and, with ``parent``, the attention library built
    from that checkout's csrc) timed in turns by graph replays beside
    ``scaled_dot_product_attention``; every variant's out and ms the plan's
    bits, the plan's out within 1e-2 of the plain version's largest value
    and its e the dense backward's e bit for bit."""
    import torch.nn.functional as F
    from pathlib import Path
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
            from vitta_tpu_torch.ops import _build
            src = Path(parent) / "vitta_tpu_torch" / "csrc" / "attention.cu"
            out = _build.BUILD_DIR / "variants" / "libattention_parent.so"
            subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(out), str(src)], check=True)
            built.append((ctypes.CDLL(str(out)), "the parent's source"))
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
    if "--dense" in args:
        args.remove("--dense")
        parent = None
        if "--parent" in args:
            at = args.index("--parent")
            parent = args[at + 1]
            del args[at:at + 2]
        sys.exit(dense_main(*(int(a) for a in args), parent=parent))
    sys.exit(main(*(int(a) for a in args)))
