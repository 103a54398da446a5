"""Smoke run of vitta_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from this checkout, checks each against its plain PyTorch version, and
drives the TANet float32 ViTTA stream and the Video Swin-B float32
forward paths end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: needs CUDA; prints the card's name and power limit.
2. build: every ``vitta_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, all
   at once.
3. TAM kernels against plain: the dynamic conv forward and backward at
   every TAM shape of ResNet-50 (n=2 adapt, n=1 eval, t=16, and t=3 for
   the zero-padded ends), values, CUDA-event and device times.
4. Video Swin kernels against plain: LayerNorm, bias expansion, packed
   window attention (with and without mask, dense and compact bias) and
   LayerNorm-MLP at every Swin-B stage shape for 1 and 2 clips; values,
   CUDA-event and device times of kernel, plain version and, where one
   PyTorch call computes the same function, that call.
5. TANet slice at small size: full-width TANet at T=2, 32x32, two
   tta_online steps on the card and on the CPU from one seeded state dict.
6. TANet slice at full size: 101 classes, 2 views x 16 frames x 224x224,
   the reference operating point (tanet_ucf101_preset), through
   ``tta_stream`` over seeded synthetic uint8 videos; the TAM launch
   counters must show 16 forward launches per forward pass and 16
   backward launches per step.
7. Swin slice at small size: the tiny config of tests/test_swin_parity.py
   (shifted windows, clamped windows, PatchMerging padding): source
   statistics and eval logits on the card against the CPU.
8. Swin-B at full width and cut depth (2, 2, 2, 1), one 16x224x224 clip:
   every tap statistic and the logits on the card against the CPU.
9. Swin-B slice at full size: swin_ucf101_preset, depths (2, 2, 18, 2),
   ``compute_source_statistics`` over batches of 2 clips, the statistics
   files written and reloaded, then ``eval_step`` over single videos; per
   forward pass the counters must show 29 LayerNorm, 24 bias, 24
   attention and 24 LayerNorm-MLP launches and no contiguity copy.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that one JSON line of the
kernels.  TF32 is switched off for matmuls and convolutions, because the
comparisons are float32 ones.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, NVIDIA's published H100 SXM peaks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# every TAM site of ResNet-50: (H, W, C) -> sites per forward pass
TAM_SITES = {(56, 56, 64): 3, (56, 56, 128): 1, (28, 28, 128): 3,
             (28, 28, 256): 1, (14, 14, 256): 5, (14, 14, 512): 1,
             (7, 7, 512): 2}
FWD_TOL = 1e-5    # tests/test_pallas_tam.py's tolerances
GRAD_TOL = 2e-4
N_VIDEOS = 6      # full-slice videos; the first two are warm-up
SEED = 0

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12       # float32 outside the tensor cores

# Swin-B on a 16x224x224 clip, per stage: width C, heads, tokens per clip,
# windows per clip (= the shift mask's nW), blocks
SWIN_WINDOW = (8, 7, 7)
SWIN_STAGES = ((128, 4, 25088, 64, 2), (256, 8, 6272, 16, 2),
               (512, 16, 1568, 4, 18), (1024, 32, 392, 1, 2))
# every LayerNorm kernel site of one forward pass: (tokens per clip, C) ->
# sites (patch-embed norm, norm1 of each block, PatchMerging norms, final)
SWIN_LN_SITES = {(25088, 128): 3, (6272, 256): 2, (6272, 512): 1,
                 (1568, 512): 18, (1568, 1024): 1, (392, 1024): 3,
                 (392, 2048): 1}
SWIN_LAUNCHES = {"ln_fwd": 29, "bias_expand": 24, "attn_packed_fwd": 24,
                 "ln_mlp_fwd": 24}     # per forward pass of Swin-B
LN_TOL = 1e-5      # the same one-pass float32 formula, sums in another order
ATTN_TOL = 2e-5    # __expf and another summation order over 392 keys
MLP_TOL = 1e-4     # tiled float32 sums over K <= 4096 terms: between the
                   # typical sqrt(K)*eps = 4e-6 and the worst K*eps = 2.4e-4
SWIN_STAT_BATCHES = 4   # of 2 clips; the first is warm-up
SWIN_EVAL_VIDEOS = 5    # of 1 clip; the first is warm-up


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn`` from torch.profiler: the summed
    durations of the kernels it launched, over ``reps`` calls.  Unlike
    ``cuda_ms`` it leaves out the host's launch overhead; None when the
    profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / reps if us > 0 else None


def device_breakdown(fn, top: int = 8):
    """(host ms, device-busy ms, [(kernel name, ms, launches)]) of one
    call of ``fn`` that ends synchronised, from torch.profiler; the busy
    time is the sum of all kernels' durations (one stream, so they do not
    overlap), the list its ``top`` largest by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return host_ms, sum(r[1] for r in rows), rows[:top]


def check_close(name, got, want, rtol, atol=None):
    """Max abs error of ``got``; raises unless |got-want| <= atol +
    rtol*|want| everywhere (atol defaults to rtol)."""
    atol = rtol if atol is None else atol
    err = (got - want).detach().abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max()):.3e} "
                             f"exceeds rtol={rtol} atol={atol}")
    return float(err.max())


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` float32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def measure(fn):
    """(CUDA-event ms, device ms or None) of one call of ``fn``."""
    with torch.no_grad():
        return cuda_ms(fn, reps=15), device_ms(fn, reps=10)


def fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


class Totals:
    """Per-forward-pass sums of one kernel's measurements over its sites:
    ``add`` takes the sites' count and one site's numbers."""

    KEYS = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
            "library_device_ms", "bytes", "flops")

    def __init__(self):
        self.sum = dict.fromkeys(self.KEYS, 0.0)
        self.err = 0.0

    def add(self, sites: int, **values):
        for key, v in values.items():
            if v is None or self.sum[key] is None:
                self.sum[key] = None      # one site not measured: no sum
            else:
                self.sum[key] += sites * v

    def row(self, name, source, replaces, has_library=True):
        ms, by = bound(self.sum["bytes"], self.sum["flops"])
        s = self.sum
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": self.err, "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": ms, "bound_by": by,
                "library_ms": s["library_ms"] if has_library else None,
                "device_ms": s["device_ms"],
                "plain_device_ms": s["plain_device_ms"],
                "library_device_ms":
                    s["library_device_ms"] if has_library else None}


# ---------------------------------------------------------------------------
def phase_tam_kernels(dev):
    """TAM kernel against plain on the card; returns its JSON rows."""
    from vitta_tpu_torch.ops.cuda_tam import (tam_bwd_cuda, tam_fwd_cuda,
                                              tam_dynamic_conv,
                                              tam_dynamic_conv_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0}
    per_step = dict.fromkeys(("fwd", "bwd", "plain_fwd", "plain_bwd"), 0.0)
    dev_step = dict.fromkeys(per_step, 0.0)
    # what one adapt step (16 sites, n=2, t=16) must move and do: forward
    # reads x, attn, K and writes out (1 multiply + 3 multiply-adds per
    # element); backward reads g and x again, writes dx, dattn, dK
    need = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    for (h, w, c), sites in TAM_SITES.items():
        for n, t in ((2, 16), (1, 16), (2, 3)):
            x = torch.randn(n, t, h, w, c, device=dev, generator=gen)
            a = torch.sigmoid(torch.randn(n, t, c, device=dev, generator=gen))
            k = torch.softmax(torch.randn(n, c, 3, device=dev, generator=gen), -1)
            g = torch.randn(n, t, h, w, c, device=dev, generator=gen)
            ins = [v.clone().requires_grad_() for v in (x, a, k)]
            refs = [v.clone().requires_grad_() for v in (x, a, k)]
            out = tam_dynamic_conv(*ins)
            out.backward(g)
            ref = tam_dynamic_conv_reference(*refs)
            ref.backward(g)
            torch.cuda.synchronize()
            e_f = check_close(f"tam fwd {(n, t, h, w, c)}", out, ref, FWD_TOL)
            e_b = max(check_close(f"tam {nm} {(n, t, h, w, c)}", p.grad, q.grad,
                                  GRAD_TOL)
                      for nm, p, q in zip(("dx", "dattn", "dkernel"), ins, refs))
            err["fwd"], err["bwd"] = max(err["fwd"], e_f), max(err["bwd"], e_b)

            ref = tam_dynamic_conv_reference(*refs)
            calls = {
                "fwd": lambda: tam_fwd_cuda(x, a, k),
                "bwd": lambda: tam_bwd_cuda(g, x, a, k),
                "plain_fwd": lambda: tam_dynamic_conv_reference(x, a, k),
                "plain_bwd": lambda: torch.autograd.grad(ref, refs, g,
                                                         retain_graph=True)}
            ev, dv = {}, {}
            for name, fn in calls.items():
                with torch.set_grad_enabled(name == "plain_bwd"):
                    ev[name], dv[name] = cuda_ms(fn), device_ms(fn)
            nbytes = x.numel() * 4
            print(f"tam n={n} t={t} {h}x{w}x{c}: err fwd {e_f:.2e} bwd "
                  f"{e_b:.2e} | event ms: fwd {ev['fwd']:.4f} plain "
                  f"{ev['plain_fwd']:.4f}, bwd {ev['bwd']:.4f} plain "
                  f"{ev['plain_bwd']:.4f} | device ms: fwd {fmt(dv['fwd'])} "
                  f"plain {fmt(dv['plain_fwd'])}, bwd {fmt(dv['bwd'])} plain "
                  f"{fmt(dv['plain_bwd'])}", flush=True)
            if (n, t) == (2, 16):
                small = (a.numel() + k.numel()) * 4
                need["fwd"][0] += sites * (2 * nbytes + small)
                need["fwd"][1] += sites * 7 * x.numel()
                need["bwd"][0] += sites * (3 * nbytes + 2 * small)
                need["bwd"][1] += sites * 14 * x.numel()
                for name in per_step:
                    per_step[name] += sites * ev[name]
                    if dev_step[name] is not None and dv[name] is not None:
                        dev_step[name] += sites * dv[name]
                    else:
                        dev_step[name] = None
                if dv["fwd"] and dv["bwd"]:
                    print(f"  kernel bandwidth: fwd {2 * nbytes / dv['fwd'] / 1e6:.0f}"
                          f" GB/s, bwd {3 * nbytes / dv['bwd'] / 1e6:.0f} GB/s "
                          "(ideal bytes over device time)", flush=True)
            del x, a, k, g, ins, refs, out, ref
    for label, d in (("event", per_step), ("device", dev_step)):
        if None in d.values():
            print(f"tam per adapt step, {label} ms: not measured", flush=True)
            continue
        print(f"tam per adapt step (16 sites, n=2, t=16), {label} ms: fwd "
              f"{d['fwd']:.3f} (plain {d['plain_fwd']:.3f}), bwd "
              f"{d['bwd']:.3f} (plain {d['plain_bwd']:.3f})", flush=True)
    rows = []
    for d, line in (("fwd", 77), ("bwd", 92)):
        ms, by = bound(*need[d])
        rows.append({
            "name": f"tam_{d}", "route": "cuda",
            "source": "vitta_tpu_torch/csrc/tam.cu",
            "replaces": f"vitta_tpu/ops/pallas_tam.py:{line}",
            "max_abs_err": err[d], "ms": per_step[d],
            "plain_ms": per_step[f"plain_{d}"], "bound_ms": ms,
            "bound_by": by,
            "library_ms": None,      # no one PyTorch call computes the TAM
            "device_ms": dev_step[d],
            "plain_device_ms": dev_step[f"plain_{d}"]})
    return rows


def _report(what, err, times):
    """One line for one shape: ``times`` is {label: (event ms, device ms)}."""
    parts = [f"{k} {ev:.4f} (device {fmt(dv)})" for k, (ev, dv) in times.items()]
    print(f"{what}: max abs err {err:.2e} | event ms: " + ", ".join(parts),
          flush=True)


def phase_swin_kernels(dev):
    """The four Video Swin forward kernels against their plain versions at
    every Swin-B stage shape, for 1 and 2 clips; returns their JSON rows,
    whose times are sums over the sites of one forward pass of 2 clips
    (the source-statistics batch)."""
    import torch.nn.functional as F
    from vitta_tpu_torch.models.swin import relative_position_index
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    from vitta_tpu_torch.ops import cuda_mlp as cm
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    a_dim = 2 * wd - 1

    # A: LayerNorm forward
    ln = Totals()
    for (tokens, c), sites in SWIN_LN_SITES.items():
        for clips in (1, 2):
            x = randn(clips * tokens, c, scale=2.0) + 0.5
            g, b = randn(c), randn(c)
            want = cl.layer_norm_reference(x, g, b, 1e-5)
            err = check_close(f"ln {tuple(x.shape)}",
                              cl.ln_fwd_cuda(x, g, b, 1e-5), want, LN_TOL)
            ln.err = max(ln.err, err)
            t = {"kernel": measure(lambda: cl.ln_fwd_cuda(x, g, b, 1e-5)),
                 "plain": measure(lambda: cl.layer_norm_reference(x, g, b, 1e-5)),
                 "F.layer_norm": measure(lambda: F.layer_norm(x, (c,), g, b, 1e-5))}
            _report(f"ln rows={clips * tokens} C={c}", err, t)
            if clips == 2:
                ln.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                       plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                       library_ms=t["F.layer_norm"][0],
                       library_device_ms=t["F.layer_norm"][1],
                       bytes=(2 * x.numel() + 2 * c) * 4, flops=8 * x.numel())
            del x, want

    # B: bias expansion; the library call is the reference's gather
    bias = Totals()
    rpi = torch.from_numpy(relative_position_index(SWIN_WINDOW).copy()).to(
        dev).reshape(-1)
    for c, nh, _tokens, _nw, depth in SWIN_STAGES:
        table = randn(a_dim * (2 * wh - 1) * (2 * ww - 1), nh)
        v = cb.compact_bias(table, SWIN_WINDOW)
        got = cb.expand_bias_cuda(v, wd)
        gather = lambda: table[rpi].reshape(n_tok, n_tok, nh).permute(
            2, 0, 1).contiguous()
        if not (torch.equal(got, cb.expand_bias_reference(v, wd))
                and torch.equal(got, gather())):
            raise AssertionError(f"bias expansion nh={nh}: the kernel, the "
                                 "plain version and the gather differ")
        t = {"kernel": measure(lambda: cb.expand_bias_cuda(v, wd)),
             "plain": measure(lambda: cb.expand_bias_reference(v, wd)),
             "gather": measure(gather)}
        _report(f"bias nh={nh} -> ({nh},{n_tok},{n_tok}), bit-exact", 0.0, t)
        bias.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                 plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                 library_ms=t["gather"][0], library_device_ms=t["gather"][1],
                 bytes=(v.numel() + got.numel()) * 4, flops=0)
        del got

    # C: packed window attention; the library call is
    # scaled_dot_product_attention on the unpacked views with
    # attn_mask = bias + mask, made outside the timed call
    attn = Totals()
    for c, nh, tokens, nw, depth in SWIN_STAGES:
        hd = c // nh
        scale = hd ** -0.5
        vc = randn(nh, a_dim, hw, hw)
        dense = cb.expand_bias_reference(vc, wd)
        mask = None
        if nw > 1:      # the last stage's window covers its input: no shift
            mask = torch.where(
                torch.rand(nw, n_tok, n_tok, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        for clips in (1, 2):
            b_ = clips * tokens // n_tok
            qkv = randn(b_, n_tok, 3 * c)
            for m in ((None, mask) if mask is not None else (None,)):
                want, want_ms = ca.packed_attention_reference(
                    qkv, dense, m, scale, nh, save_ms=True)
                err = 0.0
                for form, bias_t in (("dense", dense), ("compact", vc)):
                    got, ms_ = ca.attn_packed_fwd_cuda(qkv, bias_t, m, scale,
                                                       nh, save_ms=True)
                    what = (f"attention B_={b_} nh={nh} mask="
                            f"{m is not None} {form}")
                    err = max(err, check_close(what, got, want, ATTN_TOL),
                              check_close(what + " row max/sum", ms_, want_ms,
                                          ATTN_TOL))
                    del got, ms_
                attn.err = max(attn.err, err)
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                am = dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)
                sdpa = lambda: F.scaled_dot_product_attention(
                    q5[0], q5[1], q5[2], attn_mask=am, scale=scale)
                check_close("scaled_dot_product_attention",
                            sdpa().permute(0, 2, 1, 3).reshape(b_, n_tok, c),
                            want, 1e-3)
                t = {"kernel": measure(lambda: ca.attn_packed_fwd_cuda(
                         qkv, dense, m, scale, nh)),
                     "kernel compact": measure(lambda: ca.attn_packed_fwd_cuda(
                         qkv, vc, m, scale, nh)),
                     "plain": measure(lambda: ca.packed_attention_reference(
                         qkv, dense, m, scale, nh)),
                     "sdpa": measure(sdpa)}
                _report(f"attention B_={b_} N={n_tok} nh={nh} hd={hd} mask="
                        f"{m is not None}", err, t)
                if clips == 2:
                    # shifted blocks are every second one where there is a mask
                    sites = depth // 2 if mask is not None else depth
                    nbytes = (qkv.numel() + b_ * n_tok * c + dense.numel()
                              + (0 if m is None else m.numel())) * 4
                    flops = b_ * nh * n_tok * n_tok * (4 * hd + 6)
                    attn.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                             plain_ms=t["plain"][0],
                             plain_device_ms=t["plain"][1],
                             library_ms=t["sdpa"][0],
                             library_device_ms=t["sdpa"][1],
                             bytes=nbytes, flops=flops)
                del want, want_ms, am
            del qkv

    # D: fused LayerNorm-MLP; no one PyTorch call computes it
    mlp = Totals()
    for c, _nh, tokens, _nw, depth in SWIN_STAGES:
        f = 4 * c
        g, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
        w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
        for clips in (1, 2):
            m_rows = clips * tokens
            x = randn(m_rows, c, scale=1.5)
            args = (x, g, bt, w1, b1, w2, b2, 1e-5)
            got = cm.ln_mlp_fwd_cuda(*args, save_residuals=True)
            want = cm.ln_mlp_reference(*args, save_residuals=True)
            err = max(check_close(f"ln_mlp M={m_rows} C={c} {nm}", p, q,
                                  MLP_TOL)
                      for nm, p, q in zip(("o", "y", "a", "s"), got, want))
            mlp.err = max(mlp.err, err)
            del got, want
            t = {"kernel": measure(lambda: cm.ln_mlp_fwd_cuda(*args)),
                 "plain": measure(lambda: cm.ln_mlp_reference(*args))}
            flops = 4 * m_rows * c * f + 10 * m_rows * f + 8 * m_rows * c
            _report(f"ln_mlp M={m_rows} C={c} F={f}", err, t)
            if t["kernel"][1]:
                print(f"  kernel rate: {flops / t['kernel'][1] / 1e9:.1f} "
                      "TFLOP/s float32 (operations over device time)",
                      flush=True)
            if clips == 2:
                mlp.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                        plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                        bytes=(3 * x.numel() + 2 * c * f + f + 3 * c) * 4,
                        flops=flops)
            del x, args

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [ln.row("ln_fwd", f"{src}/ln.cu", f"{ops}/pallas_ln.py:47"),
            bias.row("bias_expand", f"{src}/bias.cu",
                     f"{ops}/pallas_bias.py:59"),
            attn.row("attn_packed_fwd", f"{src}/attention.cu",
                     f"{ops}/pallas_attention.py:448"),
            mlp.row("ln_mlp_fwd", f"{src}/mlp.cu", f"{ops}/pallas_mlp.py:303",
                    has_library=False)]
    for r in rows:
        print(f"{r['name']} per Swin-B forward pass of 2 clips "
              f"({SWIN_LAUNCHES[r['name']]} launches): event ms "
              f"{r['ms']:.3f}, device ms {fmt(r['device_ms'])}, plain "
              f"{r['plain_ms']:.3f} (device {fmt(r['plain_device_ms'])}), "
              f"library {fmt(r['library_ms'])} (device "
              f"{fmt(r['library_device_ms'])}), bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}", flush=True)
    return rows


def _cfg(clip_length, num_classes, **model_kw):
    from vitta_tpu_torch.config import tanet_ucf101_preset
    cfg = tanet_ucf101_preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=clip_length),
        model=dataclasses.replace(cfg.model, num_classes=num_classes,
                                  **model_kw))


def _videos(rng, n, t, hw, views=2):
    return [(rng.integers(0, 256, (views, t, hw, hw, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8),
             np.asarray([i % 101], np.int64)) for i in range(n)]


def _source_stats(model, clip):
    from vitta_tpu_torch.models.layers import Taps, flatten_taps
    taps = Taps({"stat"})
    with torch.no_grad():
        model(clip, taps)
    return {k: (s.mean.cpu().numpy(), s.var.cpu().numpy())
            for k, s in flatten_taps(taps).items()
            if "g_bn" not in k and "l_bn" not in k}


def phase_small_slice(seed):
    """Two tta_online steps at T=2, 32x32 on the card and on the CPU.

    Tolerances: losses rtol 1e-3 / atol 1e-5 and eval logits rtol 2e-3 /
    atol 2e-4 (cuDNN and oneDNN float32 convs sum in different orders;
    tests/test_tanet_parity.py's bound); lr is raised to 1e-2 so that the
    weight updates stand far above float32 rounding, and each tensor's
    update agrees to 2% of its norm."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.models import get_model
    cfg = _cfg(2, 101, dropout=0.0)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=1e-2))
    torch.manual_seed(seed)
    model = get_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    src = _source_stats(model, torch.from_numpy(
        rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)))
    videos = _videos(rng, 2, 2, 32)
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = VittaEngine(get_model(cfg), cfg, sd, src, device=dev)
        state = eng.init_state()
        metrics = []
        for views, clip, label in videos:
            state, m = eng.adapt_eval_step(state, views, clip, label)
            metrics.append({f: float(getattr(m, f))
                            for f in ("loss_reg", "loss_consis", "loss_ce")})
        logits = eng.eval_logits(videos[-1][1]).cpu()
        params = {k: p.detach().cpu() for k, p in eng.model.named_parameters()}
        runs[dev] = (metrics, logits, params)
    (m_gpu, l_gpu, p_gpu), (m_cpu, l_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for f in a:
            if not abs(a[f] - b[f]) <= 1e-5 + 1e-3 * abs(b[f]):
                raise AssertionError(f"step {i} {f}: card {a[f]} cpu {b[f]}")
    logit_err = check_close("eval logits", l_gpu, l_cpu, 2e-3, 2e-4)
    worst = 0.0
    for k, init in sd.items():
        if k not in p_cpu:
            continue
        dg, dc = p_gpu[k] - init, p_cpu[k] - init
        rel = float((dg - dc).norm() / (dc.norm() + 1e-12))
        if float((dg - dc).norm()) > 2e-2 * float(dc.norm()) + 1e-8:
            raise AssertionError(f"update of {k}: card and cpu differ by "
                                 f"{rel:.3e} of its norm")
        worst = max(worst, rel)
    print(f"small slice card vs cpu: losses {m_gpu} vs {m_cpu}; eval logits "
          f"max abs err {logit_err:.2e}; worst update "
          f"difference {worst:.2e} of its norm", flush=True)


class _StepTimes:
    """Collects the per-video times ``tta_stream`` reports."""

    def __init__(self):
        self.ms = []

    def scalar(self, tag, value, step):
        if tag == "tta/step_ms":
            self.ms.append(value)


def phase_full_slice(seed, n_videos, card):
    """tta_stream over seeded videos at the reference operating point;
    returns the TAM launch counts of the run."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_stream
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.ops import cuda_tam
    cfg = _cfg(16, 101)
    dev = torch.device("cuda")
    torch.manual_seed(seed)
    model = get_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    clean = torch.from_numpy(rng.normal(size=(2, 16, 224, 224, 3))
                             .astype(np.float32)).to(dev)
    src = _source_stats(model.to(dev), clean)
    del clean, model
    engine = VittaEngine(get_model(cfg), cfg, sd, src, device=dev)
    videos = _videos(rng, n_videos, 16, 224)
    writer = _StepTimes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_tam.counters.reset()
    top1, state, meters = tta_stream(engine, videos, seed=seed,
                                     metrics_writer=writer)
    torch.cuda.synchronize()
    counts = (cuda_tam.counters.fwd, cuda_tam.counters.bwd,
              cuda_tam.counters.grad_copies)
    peak = torch.cuda.max_memory_allocated()

    for k in ("loss_reg", "loss_consis", "loss_ce"):
        if not np.isfinite(meters[k].avg):
            raise AssertionError(f"{k} is not finite: {meters[k].avg}")
    if state.step != n_videos:
        raise AssertionError(f"{state.step} steps for {n_videos} videos")
    moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                for k, p in engine.model.named_parameters())
    if moved == 0:
        raise AssertionError("no parameter changed")
    ema_norm = sum(float(s.mean.abs().sum() + s.var.abs().sum())
                   for s in state.ema.values())
    if not (np.isfinite(ema_norm) and ema_norm > 0):
        raise AssertionError(f"EMA did not move (sum |ema| = {ema_norm})")
    want = (32 * n_videos, 16 * n_videos)
    if counts[:2] != want:
        raise AssertionError(f"TAM launches fwd/bwd {counts[:2]}, expected "
                             f"{want} (16+16 forward and 16 backward per step)")
    warm = writer.ms[2:]
    print(f"full slice: {n_videos} videos, median {statistics.median(warm):.3f}"
          f" ms/video after {len(writer.ms) - len(warm)} warm-up (host clock, "
          f"synchronised on the metrics; includes the uint8 host-to-device "
          f"copy), peak memory {peak / 2**30:.3f} GiB, {moved} parameter "
          f"tensors moved, losses reg {meters['loss_reg'].avg:.5f} consis "
          f"{meters['loss_consis'].avg:.5f} ce {meters['loss_ce'].avg:.5f}, "
          f"top1 {top1[0]:.1f}; TAM launches fwd {counts[0]} bwd {counts[1]}, "
          f"gradient contiguity copies {counts[2]}; on {card}", flush=True)
    return {"fwd": counts[0], "bwd": counts[1]}


# ---------------------------------------------------------------------------
def _swin_cfg(t=16, hw=224, **model_kw):
    from vitta_tpu_torch.config import swin_ucf101_preset
    cfg = swin_ucf101_preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t, input_size=hw,
                                 scale_size=hw),
        model=dataclasses.replace(cfg.model, **model_kw))


def _swin_weights(cfg, seed):
    """A seeded state dict of the model of ``cfg``; the bias tables are
    drawn wide (std 0.5, not the initialiser's 0.02) so that a wrong bias
    would show in the logits."""
    from vitta_tpu_torch.models import get_model
    torch.manual_seed(seed)
    model = get_model(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.5)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _swin_model(cfg, sd):
    from vitta_tpu_torch.models import get_model
    model = get_model(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def _normalized_batches(rng, cfg, sizes, t, hw):
    """Seeded synthetic uint8 clips, normalised on the host as a loader
    hands them to the precompute: [(float32 (B,T,S,S,3), labels)]."""
    mean = np.asarray(cfg.data.input_mean, np.float32)
    std = np.asarray(cfg.data.input_std, np.float32)
    out = []
    for b in sizes:
        clip = rng.integers(0, 256, (b, t, hw, hw, 3), dtype=np.uint8)
        out.append(((clip.astype(np.float32) - mean) / std,
                    np.zeros(b, np.int64)))
    return out


def _compare_stats(what, got, want, names):
    """Raise unless both hold exactly ``names`` and agree to rtol 1e-3 /
    atol 1e-5 (float32 sums in another order; tests/test_swin_parity.py's
    bound for tap statistics); returns the largest abs error."""
    if set(got) != set(names) or set(want) != set(names):
        raise AssertionError(f"{what}: tap names differ from the model's "
                             "norm layers")
    worst = 0.0
    for name in names:
        for kind, a, b in zip(("mean", "var"), got[name], want[name]):
            worst = max(worst, check_close(
                f"{what} {kind} {name}", torch.from_numpy(a),
                torch.from_numpy(b), 1e-3, 1e-5))
    return worst


def _swin_counts():
    from vitta_tpu_torch.models import swin
    from vitta_tpu_torch.ops import cuda_attention, cuda_bias, cuda_ln, cuda_mlp
    return {"ln_fwd": cuda_ln.counters.fwd,
            "bias_expand": cuda_bias.counters.fwd,
            "attn_packed_fwd": cuda_attention.counters.fwd,
            "ln_mlp_fwd": cuda_mlp.counters.fwd,
            "contiguity_copies": swin.counters.contiguity_copies}


def _reset_swin_counts():
    from vitta_tpu_torch.models import swin
    from vitta_tpu_torch.ops import cuda_attention, cuda_bias, cuda_ln, cuda_mlp
    for mod in (cuda_ln, cuda_bias, cuda_attention, cuda_mlp, swin):
        mod.counters.reset()


def phase_swin_card_vs_cpu(what, cfg, seed, sizes, t, hw):
    """Source statistics and eval logits of one seeded Swin on the card
    against the CPU.  Tolerances: statistics rtol 1e-3 / atol 1e-5, logits
    rtol 2e-3 / atol 2e-4 (tests/test_swin_parity.py's bounds: float32
    products summed in different orders through the blocks)."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import compute_source_statistics
    from vitta_tpu_torch.utils.checkpoint import swin_norm_layers
    sd = _swin_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    batches = _normalized_batches(rng, cfg, sizes, t, hw)
    clip = rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8)
    names = [n for n, _ in swin_norm_layers(cfg.model.depths)]
    _reset_swin_counts()
    stats, logits = {}, {}
    for dev in ("cuda", "cpu"):
        stats[dev] = compute_source_statistics(_swin_model(cfg, sd), batches,
                                               device=dev)
        eng = VittaEngine(_swin_model(cfg, sd), cfg, sd, stats[dev],
                          device=dev)
        logits[dev] = eng.eval_logits(clip).cpu()
    counts = _swin_counts()
    stat_err = _compare_stats(what, stats["cuda"], stats["cpu"], names)
    logit_err = check_close(f"{what} eval logits", logits["cuda"],
                            logits["cpu"], 2e-3, 2e-4)
    for k in SWIN_LAUNCHES:
        if counts[k] == 0:
            raise AssertionError(f"{what}: the {k} kernel was never launched")
    print(f"{what} card vs cpu: {len(names)} taps max abs err {stat_err:.2e}; "
          f"eval logits max abs err {logit_err:.2e} (|logit| up to "
          f"{float(logits['cpu'].abs().max()):.3f}); launches {counts}",
          flush=True)


class _TimedBatches:
    """Iterates over batches and notes the host clock at each hand-over;
    the consumer synchronises on each batch's statistics, so the gaps are
    whole batches."""

    def __init__(self, batches):
        self.batches = batches
        self.stamps = []

    def __iter__(self):
        for b in self.batches:
            self.stamps.append(time.perf_counter())
            yield b
        self.stamps.append(time.perf_counter())

    def ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]


def phase_swin_full_slice(cfg, seed, card):
    """The Swin of ``cfg`` (Swin-B at full width and depth) through the
    source-statistics precompute and source-only evaluation; returns the
    launch counts of the run."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import (
        compute_source_statistics, load_source_statistics_npz,
        save_source_statistics)
    from vitta_tpu_torch.utils.checkpoint import (load_reference_stats,
                                                  swin_norm_layers)
    arch, depths, classes = (cfg.model.arch, cfg.model.depths,
                             cfg.model.num_classes)
    t, hw = cfg.data.clip_length, cfg.data.input_size
    sd = _swin_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    batches = _TimedBatches(_normalized_batches(
        rng, cfg, (2,) * SWIN_STAT_BATCHES, t, hw))
    videos = [(rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8),
               np.asarray([i % classes], np.int64))
              for i in range(SWIN_EVAL_VIDEOS)]
    names = [n for n, _ in swin_norm_layers(depths)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    stats = compute_source_statistics(_swin_model(cfg, sd), batches)
    torch.cuda.synchronize()
    peak_stats = torch.cuda.max_memory_allocated()
    if set(stats) != set(names):
        raise AssertionError("statistics are not those of the model's "
                             f"{len(names)} norm layers")
    for name, (m, v) in stats.items():
        if not (m.ndim == 1 and m.shape == v.shape and np.isfinite(m).all()
                and np.isfinite(v).all() and (v >= 0).all()):
            raise AssertionError(f"statistics of {name} are not finite "
                                 "per-channel vectors")
    with tempfile.TemporaryDirectory() as tmp:
        mean_p, var_p, npz_p = save_source_statistics(
            stats, arch, tmp, tag="smoke", depths=depths)
        pair = load_reference_stats(mean_p, var_p, arch, depths=depths)
        npz = load_source_statistics_npz(npz_p)
    for name, (m, v) in stats.items():
        for loaded in (pair, npz):
            if not (np.array_equal(loaded[name][0], m)
                    and np.array_equal(loaded[name][1], v)):
                raise AssertionError(f"{name} changed through its file")

    engine = VittaEngine(_swin_model(cfg, sd), cfg, sd, pair)
    torch.cuda.reset_peak_memory_stats()
    eval_ms, preds = [], []
    for clip, label in videos:
        t0 = time.perf_counter()
        top1, top5, pred = engine.eval_step(engine.init_params, clip, label)
        preds.append(int(pred.cpu()[0]))       # synchronises
        eval_ms.append((time.perf_counter() - t0) * 1e3)
        if not 0 <= preds[-1] < classes:
            raise AssertionError(f"prediction {preds[-1]} is no class")
    logits = engine.eval_logits(videos[0][0])
    if (tuple(logits.shape) != (1, classes)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"eval logits are not finite (1, {classes})")
    torch.cuda.synchronize()
    peak_eval = torch.cuda.max_memory_allocated()
    counts = _swin_counts()

    # where the time goes, with the inputs already on the card: one tapped
    # forward of 2 clips as the precompute runs it, one eval forward of 1
    from vitta_tpu_torch.models.layers import Taps
    clips2 = torch.from_numpy(batches.batches[0][0]).cuda()
    clip1 = torch.from_numpy(videos[0][0]).cuda()
    with torch.no_grad():
        for what, fn in (
                ("tapped forward of 2 clips",
                 lambda: engine.model(clips2, Taps({"stat"}), train=False)),
                ("eval forward of 1 clip",
                 lambda: engine.eval_logits(clip1))):
            host_ms, busy, rows = device_breakdown(fn)
            if busy == 0:
                print(f"swin {what}: device time not measured", flush=True)
                continue
            print(f"swin {what}, profiled: host {host_ms:.3f} ms, device "
                  f"busy {busy:.3f} ms, idle share "
                  f"{max(0.0, 1 - busy / host_ms):.2f}; largest kernels: "
                  + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}"
                              for k, ms, n in rows), flush=True)

    forwards = SWIN_STAT_BATCHES + SWIN_EVAL_VIDEOS + 1
    per_block = sum(depths)
    want = {"ln_fwd": per_block + len(depths) + 1, "bias_expand": per_block,
            "attn_packed_fwd": per_block, "ln_mlp_fwd": per_block}
    for k, per_forward in want.items():
        if counts[k] != forwards * per_forward:
            raise AssertionError(
                f"{k}: {counts[k]} launches over {forwards} forward passes, "
                f"expected {per_forward} each")
    if counts["contiguity_copies"]:
        raise AssertionError(f"{counts['contiguity_copies']} contiguity "
                             "copies on the Swin path")
    stat_ms = batches.ms()[1:]
    print(f"swin full slice: source statistics {SWIN_STAT_BATCHES} batches of "
          f"2 clips, median {statistics.median(stat_ms) / 2:.3f} ms/clip "
          f"after 1 warm-up batch (host clock, each batch synchronised on "
          f"its statistics; float32 host-to-device copy included), peak "
          f"memory {peak_stats / 2**30:.3f} GiB, {len(names)} layers written "
          f"and "
          f"reloaded; source-only eval {SWIN_EVAL_VIDEOS} videos, median "
          f"{statistics.median(eval_ms[1:]):.3f} ms/clip after 1 warm-up "
          f"(uint8 copy and normalisation included), peak memory "
          f"{peak_eval / 2**30:.3f} GiB, predictions {preds}; launches over "
          f"{forwards} forward passes {counts}; on {card}", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vitta_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}); TF32 off for "
          "matmuls and convolutions: every comparison is float32", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {', '.join(f'{k}.cu {v:.2f} s' for k, v in built.items())}"
          f" ({time.perf_counter() - t0:.2f} s in all) into "
          f"{os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)

    dev = torch.device("cuda")
    tam_rows = phase_tam_kernels(dev)
    swin_rows = phase_swin_kernels(dev)
    phase_small_slice(SEED)
    launches = phase_full_slice(SEED, N_VIDEOS, card)
    for row in tam_rows:
        row["launches"] = launches[row["name"].split("_")[1]]
    phase_swin_card_vs_cpu(
        "swin small slice", _swin_cfg(
            t=4, hw=24, embed_dim=8, depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 8), window_size=(2, 3, 3)),
        SEED, (2, 1, 2), 4, 24)
    phase_swin_card_vs_cpu("swin-B width, depths (2,2,2,1)",
                           _swin_cfg(depths=(2, 2, 2, 1)), SEED, (1,), 16, 224)
    launches = phase_swin_full_slice(_swin_cfg(), SEED, card)
    for row in swin_rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": tam_rows + swin_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:   # any failed phase: report it, exit non-zero
        traceback.print_exc()
        sys.exit(1)
