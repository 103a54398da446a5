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
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

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
    sys.exit(main(*(int(a) for a in args)))
