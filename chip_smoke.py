"""Smoke run of vitta_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from this checkout, checks each against its plain PyTorch version, and
drives the TANet float32 ViTTA stream under each of its three
regularization modes and as the epoch-style loop, the Video Swin-B float32
forward paths and the Video Swin-B float32 ViTTA stream end to end, the
last under each of its four attention routes, and Video Swin-T's forward
paths and stream under two of them.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: needs CUDA; prints the card's name and power limit.
2. build: every ``vitta_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, all
   at once.
3. TAM kernels against plain: the dynamic conv forward and backward at
   every TAM shape of ResNet-50 (n=2 adapt, n=1 eval, t=16, and t=3 for
   the zero-padded ends), values; CUDA-event and device times at the adapt
   batch, the shapes its sums are made of.
4. Video Swin kernels against plain: LayerNorm, bias expansion, packed
   window attention (with and without mask, dense and compact bias) and
   LayerNorm-MLP at every Swin-B stage shape for 1 and 2 clips; values,
   CUDA-event and device times of kernel, plain version and, where one
   PyTorch call computes the same function, that call.  Then their four
   backward kernels (LayerNorm, bias collapse, attention with and without
   mask and with dense and compact bias, LayerNorm-MLP with and without a
   cotangent on y) at every stage shape for 2 clips, the adapt batch, each
   output against the plain backward version, the attention's also for 1
   clip (values only), where the last two stages have fewer problems than
   the card has SMs and blocks share them; every attention backward call's
   launches are read from the profiler (its kernel, the sum of the blocks'
   shares of dk and dv where problems are shared, the sum of dl over the
   windows).  The library calls timed beside them are ``F.layer_norm``'s
   backward and ``scaled_dot_product_attention``'s backward, which gives
   dq, dk and dv and no bias gradient.
5. TANet slice at small size: full-width TANet at T=2, 32x32, two
   tta_online steps on the card and on the CPU from one seeded state dict:
   losses, logits, updated parameters, EMA.
6. TANet slice at full size: 101 classes, 2 views x 16 frames x 224x224,
   the reference operating point (tanet_ucf101_preset), through
   ``tta_stream`` over seeded synthetic uint8 videos; the TAM launch
   counters must show 16 forward launches per forward pass and 16
   backward launches per step, the BatchNorm-statistics counters one
   forward and one backward launch per step at each of the 29 chosen
   BatchNorm layers (layer3 and layer4, from ``select_tap_names``) and none
   in the eval forward.  Then one profiled step: host time, device busy,
   idle share, and the busy time by class of kernel.
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

10. Swin adapt slice at small size: the tiny config again, drop-path and
   head dropout 0, two tta_online steps on the card and on the CPU from
   one seeded state dict: losses, logits, updated parameters, EMA.
11. Swin-B adapt slice at full size: swin_ucf101_preset, depths
   (2, 2, 18, 2), drop-path 0.2 and head dropout 0.5 on, the statistics of
   phase 9, ``tta_stream`` over seeded synthetic uint8 videos (2 views and
   1 eval clip each); per video the counters must show 2 x (29, 24, 24,
   24) forward launches and 29 / 24 / 24 / 24 backward launches of
   LayerNorm / bias collapse / attention / LayerNorm-MLP.

12. Projection-fused attention kernels against plain: ``attn_proj`` and
   ``attn_ln_proj`` (qkv projection, window attention and output
   projection in one op, without and with the LayerNorm in front) at every
   Swin-B stage shape, forward for 1 clip (values only) and 2 clips,
   backward for 2 clips, with and without mask, the LayerNorm form with
   and without a cotangent on y: every output, two backward runs
   bit-equal, CUDA-event and device times of kernel and plain version; for ``attn_proj`` the library call
   ``F.multi_head_attention_forward`` (packed in-projection, attn_mask =
   bias + mask made outside the timed call, ``need_weights=False``) and
   its backward under autograd, which gives no bias gradient; no one call
   computes the LayerNorm form with its second output y.  Beside both,
   the device time of the composition the op replaces (LayerNorm kernel,
   ``F.linear``, packed attention kernel, ``F.linear``).
13. Small slices of the two projection-fused routes: the tiny Swin under
   ``attn_route="proj"`` and ``"ln_proj"``, source statistics and eval
   logits (as phase 7) and two tta_online steps (as phase 10) on the card
   against the CPU.
14. Swin-B slices of the two routes at full size: under ``"ln_proj"`` the
   precompute and ``eval_step`` of phase 9 (statistics and logits must
   agree with phase 9's packed route) and ``tta_stream`` over 5 videos;
   under ``"proj"`` ``tta_stream`` over 3 videos.  Per forward pass the
   counters must show, under ``"ln_proj"``, 24 ``attn_ln_proj``, 5
   LayerNorm, 24 bias and 24 LayerNorm-MLP launches, no packed attention
   and no contiguity copy, per step as many backward launches; under
   ``"proj"`` 29 LayerNorm and 24 ``attn_proj``.  Ends with one line per
   route: ms/video, host time, device busy, idle share, peak memory.

15. MLP kernels without the LayerNorm and attention kernels per (head,
   window) against plain, forward and backward, at every Swin-T and every
   Swin-B stage shape for 2 clips, the attention with and without mask on
   q, k, v as views of a packed projection output: every output, two
   backward runs bit-equal, the attention backward (from the row maximum
   and sum its forward kept) making the packed backward's launches and none
   of the forward kernel, CUDA-event and device times of kernel and plain
   version; beside the MLP the ``F.linear``-``F.gelu``-``F.linear``
   composition and its backward under autograd, beside the attention
   ``scaled_dot_product_attention`` and its backward.
16. Small slices of the ``"heads"`` route and of both branches of the MLP
   (norm2 inside the LayerNorm-MLP kernel where the width is a multiple of
   128, apart otherwise): the tiny Swin under ``attn_route="heads"``, and
   embed 16 over four stages at 48x48 (widths 16 to 128) under ``"heads"``
   and packed; source statistics, eval logits and two tta_online steps on
   the card against the CPU, as phases 7 and 10.
17. Video Swin-T at full size (embed 96, depths (2, 2, 6, 2), heads
   (3, 6, 12, 24), otherwise swin_ucf101_preset): the precompute and
   ``eval_step`` of phase 9 and ``tta_stream`` over 6 videos on the packed
   route, then both again under ``"heads"`` (statistics and logits must
   agree with the packed route's); per forward pass the counters must show
   21 LayerNorm (12 norm1, 4 norm2 of stages 1-2, 5 others), 12 bias, 4 MLP
   and 8 LayerNorm-MLP launches, 12 packed or 12 per-(head, window)
   attention launches and none of the other, per step as many backward
   launches, and no contiguity copy.  Then Swin-B's ``tta_stream`` over 3
   videos under ``"heads"``.

18. BatchNorm-statistics kernels against plain (``fused_bn_relu_stats``:
   BatchNorm in its inference form, optional ReLU, channel mean and
   variance of the output): forward and backward with cotangents on all
   three outputs, ``relu`` False and True, at every BatchNorm2d shape a
   TANet mean_var step reads (R from 1,568 to 25,088, C from 256 to 2,048)
   and the two BatchNorm1d shapes of a TAM; y, m, v, dx, dscale, dbias, two
   runs bit-equal; CUDA-event and device times of kernel and plain version
   summed over one adapt pass.  No one PyTorch call returns y and the
   statistics, so the library time is none; the composition
   ``F.batch_norm`` (eval form) + ``torch.var_mean`` is timed beside it.
19. Small slices of the engine's other modes, card against CPU, two steps
   each as phase 5: TANet under BNS (``running_manner`` True and False),
   under cossim (``l1_loss``), with Adam on the norm layers' affine
   parameters, and through ``tta_epoch_adapt``; the tiny Swin of phase 10
   under cossim.
20. TANet at full size in those modes: a 3-video ``tta_stream`` under BNS
   and one under cossim (one warm-up each; the BatchNorm-statistics
   kernels must not run: neither reads the output's spatiotemp leaf), and
   ``tta_epoch_adapt`` over 3 videos with its ``validate`` pass (29 forward
   and 29 backward launches per step).  Ends with one line per mode:
   ms/video, host time, device busy, idle share, peak memory.

Phases run in the order 1-4, 12, 15, 18, 5, 6, 19, 20, 7-11, 13, 14, 16, 17.  No
earlier full-size stream was cut for phases 18 to 20.  To leave the time to
phases 10 and 11, phase 9 runs 3 statistics batches and 4 eval videos
where it ran 4 and 5, and the TANet slice 5 videos where it ran 6; to
leave it to phases 12 to 14, phases 3 and 4 time each call over 6 and 7
runs (4 under the profiler) where they took 25 and 15 (20 and 10), and
phase 12 over 5 (3) and only at 2 clips, the shapes its sums are made of;
to leave it to phases 15 to 17, phase 3 times the adapt batch only.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that one JSON line of the
kernels.  TF32 is switched off for matmuls and convolutions, because the
comparisons are float32 ones.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, NVIDIA's published H100 SXM peaks.  The
attention backward runs its matrix products on the tensor cores in split
TF32; its rows also carry ``tf32x3_floor_ms``, three tf32 products of
those products at the dense TF32 rate of 495 TFLOP/s.
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

# the set-up shared with vitta_tpu_torch/tools/attention_routes.py; without
# the package beside this file the run ends here
from vitta_tpu_torch.tools.synthetic import (
    SWIN_MODELS, StepTimes as _StepTimes, device_breakdown,
    normalized_batches as _normalized_batches, swin_cfg as _swin_cfg,
    swin_weights as _swin_weights, videos as _videos)
from vitta_tpu_torch.tools.tanet_breakdown import (
    profile_step as _profile_step, tanet_cfg as _cfg,
    tanet_engine as _tanet_engine, tanet_source as _tanet_source)

ROOT = os.path.dirname(os.path.abspath(__file__))

# every TAM site of ResNet-50: (H, W, C) -> sites per forward pass
TAM_SITES = {(56, 56, 64): 3, (56, 56, 128): 1, (28, 28, 128): 3,
             (28, 28, 256): 1, (14, 14, 256): 5, (14, 14, 512): 1,
             (7, 7, 512): 2}
FWD_TOL = 1e-5    # tests/test_pallas_tam.py's tolerances
GRAD_TOL = 2e-4
N_VIDEOS = 5      # full-slice videos; the first two are warm-up
TANET_MODE_VIDEOS = 3   # the BNS, cossim and epoch-style streams; one warm-up
# every BatchNorm2d of layer3 and layer4 on the adapt batch of 2 x 16 frames
# at 224 x 224, the layers a TANet mean_var step reads: (rows, C) -> sites
BN_SITES = {(25088, 256): 1, (6272, 256): 11, (6272, 1024): 7,
            (6272, 512): 1, (1568, 512): 5, (1568, 2048): 4}
# the two BatchNorm1d shapes of a TAM (layer3's: g_bn (N*C, 2T), l_bn (N, T,
# C/4)), values only
BN1D_SHAPES = (((512, 32), "g_bn"), ((2, 16, 64), "l_bn"))
BN_TOL = 1e-5       # y and m; v rtol 1e-4 / atol 1e-5 (tests/test_pallas_
                    # stats.py's): E[y^2] - m^2 from sums in another order
BN_BWD_TOL = 2e-5   # of each gradient's largest value, as LN_BWD_TOL's kind
SEED = 0

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12       # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # dense TF32 on the tensor cores

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
LN_TOL = 1e-5      # the same one-pass float32 formula, sums in another order
ATTN_TOL = 2e-5    # __expf and another summation order over 392 keys
MLP_TOL = 1e-4     # tiled float32 sums over K <= 4096 terms: between the
                   # typical sqrt(K)*eps = 4e-6 and the worst K*eps = 2.4e-4
SWIN_STAT_BATCHES = 3   # of 2 clips; the first is warm-up
SWIN_EVAL_VIDEOS = 4    # of 1 clip; the first is warm-up
SWIN_ADAPT_VIDEOS = 6   # of 2 views + 1 eval clip; the first two are warm-up
# Swin-T (embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24)): the same
# tokens and windows per stage as Swin-B
SWIN_T_STAGES = ((96, 3, 25088, 64, 2), (192, 6, 6272, 16, 2),
                 (384, 12, 1568, 4, 6), (768, 24, 392, 1, 2))
SWIN_T_STAT_EVAL_VIDEOS = 3   # Swin-T's eval videos; one warm-up
SWIN_T_VIDEOS = 6             # Swin-T's streams; two warm-up
SWIN_B_HEADS_VIDEOS = 3       # Swin-B's stream under "heads"; one warm-up
SWIN_LN_PROJ_VIDEOS = 5   # the ln_proj route's stream; two warm-up
SWIN_PROJ_VIDEOS = 3      # the proj route's stream; one warm-up
SWIN_PROJ_EVAL_VIDEOS = 3   # the ln_proj route's eval videos; one warm-up
# backward kernels: |error| <= tol * (largest |value| of the plain version's
# tensor).  The sums over rows and windows are taken in chunks and the
# chunks added in order, not in the plain version's order; float32
# throughout, the attention's products in split TF32.  Measured on an H100:
# at most 1e-6 (LayerNorm), 5e-6 (attention), 3e-6 (LayerNorm-MLP, dx after
# two sums over up to 4096 terms).
LN_BWD_TOL = 1e-5
ATTN_BWD_TOL = 2e-5
MLP_BWD_TOL = 2e-5
# the projection-fused attention: |error| <= tol + tol * |value| forward, as
# MLP_TOL (its qkv comes from a tiled float32 sum over K <= 1024 terms, goes
# through the softmax of ATTN_TOL and a second such sum), and tol * (largest
# |value|) backward, as MLP_BWD_TOL with room for the two further products
# and the recomputed qkv in the chain
PROJ_TOL = 1e-4
PROJ_BWD_TOL = 5e-5


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
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        # every kernel name was launched in each of the calls: a count that
        # is no multiple of them means the trace lost events, so once more
        if events and all(e.count % reps == 0 for e in events):
            break
    us = sum(e.self_device_time_total for e in events)
    return us / 1e3 / reps if us > 0 else None


def check_close(name, got, want, rtol, atol=None):
    """Max abs error of ``got``; raises unless |got-want| <= atol +
    rtol*|want| everywhere (atol defaults to rtol)."""
    atol = rtol if atol is None else atol
    err = (got - want).detach().abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max()):.3e} "
                             f"exceeds rtol={rtol} atol={atol}")
    return float(err.max())


def check_scaled(name, got, want, tol):
    """Max abs error of ``got``; raises unless it is at most ``tol`` times
    the largest magnitude in ``want``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    err = float((got - want).detach().abs().max())
    scale = float(want.detach().abs().max())
    if not err <= tol * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs error {err:.3e} exceeds {tol} "
                             f"of the largest value {scale:.3e}")
    return err


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` float32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def measure(fn, reps: int = 7, dev_reps: int = 4, grad: bool = False):
    """(CUDA-event ms, device ms or None) of one call of ``fn``; the
    profiler is asked once more where it recorded no kernel."""
    with torch.set_grad_enabled(grad):
        event = cuda_ms(fn, reps=reps)
        device = device_ms(fn, reps=dev_reps)
        return event, device_ms(fn, reps=dev_reps) if device is None else device


def fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def kernel_launches(fn):
    """{kernel name: launches} of one call of ``fn``, from torch.profiler
    (asked again where it recorded no kernel)."""
    for _attempt in range(3):
        _host, _busy, rows = device_breakdown(fn, top=None)
        if rows:
            return {name: launches for name, _ms, launches in rows}
    raise AssertionError("the profiler recorded no kernel")


def check_attn_bwd_launches(what, fn, split):
    """The launches of one attention backward call: attn_bwd_kernel, the
    sum of the blocks' shares of dk and dv where ``split`` > 1 blocks share
    a problem, the sum of dl over the windows; no forward kernel.  Returns
    their number."""
    names = kernel_launches(fn)
    want = 2 + (split > 1)
    if (sum(names.values()) != want
            or any("attn_fwd_kernel" in k for k in names)
            or not any("attn_bwd_kernel" in k for k in names)):
        raise AssertionError(f"{what}: launches {names}, expected {want} "
                             "with attn_bwd_kernel and no forward kernel")
    return want


class Totals:
    """Per-forward-pass sums of one kernel's measurements over its sites:
    ``add`` takes the sites' count and one site's numbers."""

    KEYS = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
            "library_device_ms", "bytes", "flops", "tc_flops")

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
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": self.err, "ms": s["ms"],
               "plain_ms": s["plain_ms"], "bound_ms": ms, "bound_by": by,
               "library_ms": s["library_ms"] if has_library else None,
               "device_ms": s["device_ms"],
               "plain_device_ms": s["plain_device_ms"],
               "library_device_ms":
                   s["library_device_ms"] if has_library else None}
        if s["tc_flops"]:
            # products on the tensor cores in split TF32: three tf32
            # products for each, at the dense TF32 rate
            row["tf32x3_floor_ms"] = 3 * s["tc_flops"] / TF32_FLOP_PER_S * 1e3
        return row


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
            if (n, t) != (2, 16):   # held to plain; the adapt batch is timed
                print(f"tam n={n} t={t} {h}x{w}x{c}: err fwd {e_f:.2e} bwd "
                      f"{e_b:.2e}", flush=True)
                del x, a, k, g, ins, refs, out, ref
                continue

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
                    ev[name], dv[name] = (cuda_ms(fn, reps=6, warmup=2),
                                          device_ms(fn, reps=4))
            nbytes = x.numel() * 4
            print(f"tam n={n} t={t} {h}x{w}x{c}: err fwd {e_f:.2e} bwd "
                  f"{e_b:.2e} | event ms: fwd {ev['fwd']:.4f} plain "
                  f"{ev['plain_fwd']:.4f}, bwd {ev['bwd']:.4f} plain "
                  f"{ev['plain_bwd']:.4f} | device ms: fwd {fmt(dv['fwd'])} "
                  f"plain {fmt(dv['plain_fwd'])}, bwd {fmt(dv['bwd'])} plain "
                  f"{fmt(dv['plain_bwd'])}", flush=True)
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
    every Swin-B stage shape, for 1 and 2 clips, then the four backward
    kernels for 2 clips; returns their JSON rows, whose times are sums
    over the sites of one forward or backward pass of 2 clips (the
    source-statistics batch and the adapt batch)."""
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


    # ------------------------------------------------------------------
    # the backward kernels, at the adapt batch of 2 clips
    # E: LayerNorm backward; the library call is F.layer_norm's backward
    ln_b = Totals()
    for (tokens, c), sites in SWIN_LN_SITES.items():
        x = randn(2 * tokens, c, scale=2.0) + 0.5
        g, b, dy = randn(c), randn(c), randn(2 * tokens, c)
        want = cl.layer_norm_backward_reference(x, g, dy, 1e-5)
        got = cl.ln_bwd_cuda(x, g, dy, 1e-5)
        err = max(check_scaled(f"ln bwd {tuple(x.shape)} {nm}", p, q,
                               LN_BWD_TOL)
                  for nm, p, q in zip(("dx", "dgamma", "dbeta"), got, want))
        ln_b.err = max(ln_b.err, err)
        del got, want
        leaves = [v.clone().requires_grad_() for v in (x, g, b)]
        y_lib = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], 1e-5)
        t = {"kernel": measure(lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5)),
             "plain": measure(lambda: cl.layer_norm_backward_reference(
                 x, g, dy, 1e-5)),
             "F.layer_norm backward": measure(lambda: torch.autograd.grad(
                 y_lib, leaves, dy, retain_graph=True))}
        _report(f"ln bwd rows={2 * tokens} C={c}", err, t)
        ln_b.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                 plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                 library_ms=t["F.layer_norm backward"][0],
                 library_device_ms=t["F.layer_norm backward"][1],
                 bytes=(3 * x.numel() + 3 * c) * 4, flops=14 * x.numel())
        del x, dy, leaves, y_lib

    # F: bias collapse; no one PyTorch call computes it
    coll = Totals()
    for c, nh, _tokens, _nw, depth in SWIN_STAGES:
        db = randn(nh, n_tok, n_tok)
        got = cb.collapse_bias_cuda(db, wd)
        if not torch.equal(got, cb.collapse_bias_reference(db, wd)):
            raise AssertionError(f"bias collapse nh={nh}: the kernel and the "
                                 "plain version differ")
        t = {"kernel": measure(lambda: cb.collapse_bias_cuda(db, wd)),
             "plain": measure(lambda: cb.collapse_bias_reference(db, wd))}
        _report(f"bias collapse ({nh},{n_tok},{n_tok}) -> nh={nh}, bit-exact",
                0.0, t)
        coll.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                 plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                 bytes=(db.numel() + got.numel()) * 4, flops=db.numel())
        del db, got

    # G: attention backward; the library call is
    # scaled_dot_product_attention's backward for dq, dk, dv (it has no
    # bias gradient).  One clip too, values and launches only: Swin-B's
    # last two stages then have fewer problems than the card has SMs, and
    # blocks share a problem (at 2 clips the last stage already does)
    attn_b = Totals()
    for c, nh, tokens, nw, depth in SWIN_STAGES:
        hd = c // nh
        scale = hd ** -0.5
        vc = randn(nh, a_dim, hw, hw)
        dense = cb.expand_bias_reference(vc, wd)
        mask = None
        if nw > 1:
            mask = torch.where(
                torch.rand(nw, n_tok, n_tok, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        for clips in (2, 1):
            b_ = clips * tokens // n_tok
            split = ca.bwd_split(b_, nh, dev)
            qkv, g = randn(b_, n_tok, 3 * c), randn(b_, n_tok, c)
            for m in ((None, mask) if mask is not None else (None,)):
                _out, ms_ = ca.attn_packed_fwd_cuda(qkv, dense, m, scale, nh,
                                                    save_ms=True)
                want = ca.packed_attention_backward_reference(
                    qkv, dense, m, ms_, g, scale, nh)
                want_c = cb.collapse_bias_reference(want[1], wd)
                what = (f"attention bwd B_={b_} N={n_tok} nh={nh} hd={hd} "
                        f"mask={m is not None}")
                err = 0.0
                for form, bias_t, want_db in (("dense", dense, want[1]),
                                              ("compact", vc, want_c)):
                    got = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                  scale, nh)
                    for i, nm in enumerate(("dq", "dk", "dv")):
                        err = max(err, check_scaled(
                            f"{what} {form} {nm}",
                            got[0][..., i * c:(i + 1) * c],
                            want[0][..., i * c:(i + 1) * c], ATTN_BWD_TOL))
                    err = max(err, check_scaled(f"{what} {form} dbias",
                                                got[1], want_db, ATTN_BWD_TOL))
                    again = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                    scale, nh)
                    if not (torch.equal(again[0], got[0])
                            and torch.equal(again[1], got[1])):
                        raise AssertionError(f"{what} {form}: two runs differ")
                    del got, again
                attn_b.err = max(attn_b.err, err)
                del want, want_c
                launches = check_attn_bwd_launches(
                    what, lambda: ca.attn_packed_bwd_cuda(
                        qkv, dense, m, ms_, g, scale, nh), split)
                what += f", {split} block(s) a problem, {launches} launches"
                if clips == 1:
                    print(f"{what}: max abs err {err:.2e}, two runs "
                          "bit-equal", flush=True)
                    del ms_
                    continue
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                leaves = [q5[i].detach().requires_grad_() for i in range(3)]
                am = dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)
                o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=am,
                                                       scale=scale)
                g4 = g.reshape(b_, n_tok, nh, hd).permute(0, 2, 1, 3)
                t = {"kernel": measure(lambda: ca.attn_packed_bwd_cuda(
                         qkv, dense, m, ms_, g, scale, nh)),
                     "kernel compact": measure(lambda: ca.attn_packed_bwd_cuda(
                         qkv, vc, m, ms_, g, scale, nh)),
                     "plain": measure(
                         lambda: ca.packed_attention_backward_reference(
                             qkv, dense, m, ms_, g, scale, nh)),
                     "sdpa backward": measure(lambda: torch.autograd.grad(
                         o_lib, leaves, g4, retain_graph=True))}
                _report(what, err, t)
                sites = depth // 2 if mask is not None else depth
                nbytes = (2 * qkv.numel() + g.numel() + ms_.numel()
                          + 2 * dense.numel()
                          + (0 if m is None else m.numel())) * 4
                pairs = b_ * nh * n_tok * n_tok
                attn_b.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                           plain_ms=t["plain"][0],
                           plain_device_ms=t["plain"][1],
                           library_ms=t["sdpa backward"][0],
                           library_device_ms=t["sdpa backward"][1],
                           bytes=nbytes, flops=pairs * (10 * hd + 12),
                           tc_flops=pairs * 10 * hd)
                del leaves, am, o_lib, ms_
            del qkv, g

    # H: LayerNorm-MLP backward; no one PyTorch call computes it.  The
    # tap's cotangent on y exists at the chosen blocks, stages 3 and 4
    mlp_b = Totals()
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for stage, (c, _nh, tokens, _nw, depth) in enumerate(SWIN_STAGES):
        f = 4 * c
        gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
        w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
        m_rows = 2 * tokens
        x = randn(m_rows, c, scale=1.5)
        _o, y, a, s_ = cm.ln_mlp_fwd_cuda(x, gm, bt, w1, b1, w2, b2, 1e-5,
                                          save_residuals=True)
        go, gy_full = randn(m_rows, c), randn(m_rows, c)
        for gy in (gy_full, None):
            args = (x, y, a, s_, go, gy, gm, w1, w2, 1e-5)
            got = cm.ln_mlp_bwd_cuda(*args)
            want = cm.ln_mlp_backward_reference(*args)
            err = max(check_scaled(f"ln_mlp bwd M={m_rows} C={c} gy="
                                   f"{gy is not None} {nm}", p, q, MLP_BWD_TOL)
                      for nm, p, q in zip(names, got, want))
            mlp_b.err = max(mlp_b.err, err)
            del got, want
            t = {"kernel": measure(lambda: cm.ln_mlp_bwd_cuda(*args)),
                 "plain": measure(lambda: cm.ln_mlp_backward_reference(*args))}
            flops = 8 * m_rows * c * f + 4 * m_rows * f + 20 * m_rows * c
            _report(f"ln_mlp bwd M={m_rows} C={c} F={f} gy={gy is not None}",
                    err, t)
            if t["kernel"][1]:
                print(f"  kernel rate: {flops / t['kernel'][1] / 1e9:.1f} "
                      "TFLOP/s float32 (operations over device time)",
                      flush=True)
            if (gy is not None) == (stage >= 2):
                nbytes = ((5 if gy is not None else 4) * m_rows * c
                          + 2 * m_rows * f + 4 * c * f + f + 4 * c) * 4
                mlp_b.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                          plain_ms=t["plain"][0],
                          plain_device_ms=t["plain"][1], bytes=nbytes,
                          flops=flops)
        del x, y, a, s_, go, gy_full, args

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [ln.row("ln_fwd", f"{src}/ln.cu", f"{ops}/pallas_ln.py:47"),
            bias.row("bias_expand", f"{src}/bias.cu",
                     f"{ops}/pallas_bias.py:59"),
            attn.row("attn_packed_fwd", f"{src}/attention.cu",
                     f"{ops}/pallas_attention.py:448"),
            mlp.row("ln_mlp_fwd", f"{src}/mlp.cu", f"{ops}/pallas_mlp.py:303",
                    has_library=False),
            ln_b.row("ln_bwd", f"{src}/ln.cu", f"{ops}/pallas_ln.py:55"),
            coll.row("bias_collapse", f"{src}/bias.cu",
                     f"{ops}/pallas_bias.py:67", has_library=False),
            attn_b.row("attn_packed_bwd", f"{src}/attention.cu",
                       f"{ops}/pallas_attention.py:517"),
            mlp_b.row("ln_mlp_bwd", f"{src}/mlp.cu", f"{ops}/pallas_mlp.py:322",
                      has_library=False)]
    fwd, bwd = swin_launches(None)
    per_pass = {**fwd, **bwd}
    for r in rows:
        print(f"{r['name']} per Swin-B pass of 2 clips "
              f"({per_pass[r['name']]} launches): event ms "
              f"{r['ms']:.3f}, device ms {fmt(r['device_ms'])}, plain "
              f"{r['plain_ms']:.3f} (device {fmt(r['plain_device_ms'])}), "
              f"library {fmt(r['library_ms'])} (device "
              f"{fmt(r['library_device_ms'])}), bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}{_floor(r)}", flush=True)
    return rows


def _floor(row) -> str:
    """The split-TF32 floor of a row whose products run on the tensor
    cores, to print beside its float32 bound."""
    if "tf32x3_floor_ms" not in row:
        return ""
    return (f"; split-TF32 floor {row['tf32x3_floor_ms']:.4f} (3 tf32 "
            "products of its matrix products at 495 TFLOP/s)")


def phase_swin_proj_kernels(dev):
    """The projection-fused window attention kernels, with and without the
    LayerNorm prologue, against their plain versions at every Swin-B stage
    shape: forward for 1 and 2 clips, backward for 2 clips, with and
    without mask, the LayerNorm form with and without a cotangent on y.
    Returns their JSON rows, whose times are sums over the 24 sites of one
    forward or backward pass of 2 clips.  The library call of ``attn_proj``
    is ``F.multi_head_attention_forward`` on the token-major (N, B_, C) copy
    of x, with the packed in-projection, attn_mask = bias + mask of shape
    (B_*nh, N, N) made outside the timed call and ``need_weights=False``,
    and its backward under autograd for dx and the four projection
    gradients (it gives no bias gradient); the LayerNorm form returns y as
    well, which no one call computes.  Beside each op the composition it
    replaces is timed too (LayerNorm kernel, ``F.linear``, packed attention
    kernel, ``F.linear``, and their backward under autograd): that one
    runs the port's own kernels, so it is no library time."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_attention_proj as cp
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def quick(fn, grad=False):
        return measure(fn, reps=5, dev_reps=3, grad=grad)

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    eps = 1e-5
    tot = {k: Totals() for k in ("proj_fwd", "proj_bwd", "ln_proj_fwd",
                                 "ln_proj_bwd")}
    comp = dict.fromkeys(tot, 0.0)       # the composition's device ms

    def add_composition(key, sites, device_ms):
        comp[key] = None if (device_ms is None or comp[key] is None) \
            else comp[key] + sites * device_ms

    bwd_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    ln_bwd_names = ("dx", "dgamma", "dbeta") + bwd_names[1:]
    for stage, (c, nh, tokens, nw, depth) in enumerate(SWIN_STAGES):
        hd = c // nh
        scale = hd ** -0.5
        gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        wqkv, bqkv = randn(3 * c, c, scale=c ** -0.5), 0.1 * randn(3 * c)
        wproj, bproj = randn(c, c, scale=c ** -0.5), 0.1 * randn(c)
        dense = cb.expand_bias_reference(
            randn(nh, 2 * wd - 1, hw, hw), wd)
        mask = None
        if nw > 1:
            mask = torch.where(
                torch.rand(nw, n_tok, n_tok, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        w = (wqkv, bqkv, wproj, bproj)
        for clips in (1, 2):
            b_ = clips * tokens // n_tok
            m_rows = b_ * n_tok
            x = randn(b_, n_tok, c, scale=1.5) + 0.3
            g = randn(b_, n_tok, c)
            gy_full = randn(b_, n_tok, c)
            for m in ((None, mask) if mask is not None else (None,)):
                tag = (f"B_={b_} N={n_tok} C={c} nh={nh} mask="
                       f"{m is not None}")
                sites = depth // 2 if mask is not None else depth
                attn_flops = b_ * nh * n_tok * n_tok * (4 * hd + 6)
                small = (4 * c * c + 4 * c + dense.numel()
                         + (0 if m is None else m.numel()))
                # forward, both forms
                got = cp.attn_proj_fwd(x, *w, dense, m, scale, nh, True)
                want = cp.proj_attention_reference(x, *w, dense, m, scale, nh,
                                                   True)
                err = max(check_close(f"attn_proj fwd {tag} {nm}", p_, q_,
                                      PROJ_TOL)
                          for nm, p_, q_ in zip(("out", "o_att", "ms"), got,
                                                want))
                tot["proj_fwd"].err = max(tot["proj_fwd"].err, err)
                got_ln = cp.attn_ln_proj_fwd(x, gm, bt, eps, *w, dense, m,
                                             scale, nh, True)
                want_ln = cp.ln_proj_attention_reference(
                    x, gm, bt, eps, *w, dense, m, scale, nh, True)
                err_ln = max(check_close(f"attn_ln_proj fwd {tag} {nm}", p_,
                                         q_, PROJ_TOL)
                             for nm, p_, q_ in zip(("out", "y", "o_att", "ms"),
                                                   got_ln, want_ln))
                tot["ln_proj_fwd"].err = max(tot["ln_proj_fwd"].err, err_ln)
                _o, o_att, ms_ = got
                _o, _y, o_att_ln, ms_ln = got_ln
                want_out = want[0]
                del got, want, got_ln, want_ln, _o, _y

                def composition(xin, with_ln):
                    y = cl.layer_norm(xin, gm, bt, eps) if with_ln else xin
                    qkv = F.linear(y, wqkv, bqkv)
                    o = ca.window_attention_packed(qkv, dense, m, scale, nh)
                    return F.linear(o, wproj, bproj), y

                if clips == 1:      # the eval batch: held to plain, not timed
                    print(f"attn_proj / attn_ln_proj fwd {tag}: max abs err "
                          f"{max(err, err_ln):.2e}", flush=True)
                    continue
                times = {"proj": quick(lambda: cp.attn_proj_fwd(
                             x, *w, dense, m, scale, nh)),
                         "ln_proj": quick(lambda: cp.attn_ln_proj_fwd(
                             x, gm, bt, eps, *w, dense, m, scale, nh))}
                am = (dense[None] if m is None else
                      dense[None, None] + m[None, :, None]).expand(
                          b_ // nw, nw, nh, n_tok, n_tok).reshape(
                              b_ * nh, n_tok, n_tok)
                x_t = x.transpose(0, 1).contiguous()

                def mha(xin, wq, bq, wp_, bp_):
                    return F.multi_head_attention_forward(
                        xin, xin, xin, c, nh, wq, bq, None, None, False,
                        0.0, wp_, bp_, training=False, need_weights=False,
                        attn_mask=am)[0]

                check_close(f"multi_head_attention_forward {tag}",
                            mha(x_t, *w).transpose(0, 1), want_out, 1e-3)
                times.update({
                    "proj library": quick(lambda: mha(x_t, *w)),
                    "proj plain": quick(lambda: cp.proj_attention_reference(
                        x, *w, dense, m, scale, nh)),
                    "ln_proj plain": quick(
                        lambda: cp.ln_proj_attention_reference(
                            x, gm, bt, eps, *w, dense, m, scale, nh)),
                    "proj composition": quick(
                        lambda: composition(x, False)),
                    "ln_proj composition": quick(
                        lambda: composition(x, True))})
                _report(f"attn_proj / attn_ln_proj fwd {tag}",
                        max(err, err_ln), times)
                flops = 8 * m_rows * c * c + attn_flops
                tot["proj_fwd"].add(
                    sites, library_ms=times["proj library"][0],
                    library_device_ms=times["proj library"][1])
                for key, form, extra in (("proj_fwd", "proj", 0),
                                         ("ln_proj_fwd", "ln_proj", 1)):
                    tot[key].add(
                        sites, ms=times[form][0], device_ms=times[form][1],
                        plain_ms=times[f"{form} plain"][0],
                        plain_device_ms=times[f"{form} plain"][1],
                        bytes=((2 + extra) * m_rows * c + small
                               + 2 * extra * c) * 4,
                        flops=flops + extra * 8 * m_rows * c)
                    add_composition(key, sites,
                                    times[f"{form} composition"][1])

                # backward, both forms, at the adapt batch
                bflops = (16 * m_rows * c * c
                          + b_ * nh * n_tok * n_tok * (10 * hd + 12))
                got = cp.attn_proj_bwd(x, wqkv, bqkv, wproj, dense, m, o_att,
                                       ms_, g, scale, nh)
                want = cp.proj_attention_backward_reference(
                    x, wqkv, bqkv, wproj, dense, m, o_att, ms_, g, scale, nh)
                err = max(check_scaled(f"attn_proj bwd {tag} {nm}", p_, q_,
                                       PROJ_BWD_TOL)
                          for nm, p_, q_ in zip(bwd_names, got, want))
                again = cp.attn_proj_bwd(x, wqkv, bqkv, wproj, dense, m,
                                         o_att, ms_, g, scale, nh)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    raise AssertionError(f"attn_proj bwd {tag}: two runs "
                                         "differ")
                tot["proj_bwd"].err = max(tot["proj_bwd"].err, err)
                del got, want, again
                leaves = [v.detach().clone().requires_grad_()
                          for v in (x, wqkv, bqkv, wproj, bproj, dense)]

                def comp_graph(with_ln):
                    xin, wq, bq, wp_, bp_, bias_ = leaves
                    y = cl.layer_norm(xin, gm_l, bt_l, eps) if with_ln else xin
                    o = ca.window_attention_packed(F.linear(y, wq, bq), bias_,
                                                   m, scale, nh)
                    return F.linear(o, wp_, bp_), y

                gm_l = gm.detach().clone().requires_grad_()
                bt_l = bt.detach().clone().requires_grad_()
                lib_leaves = [v.detach().clone().requires_grad_()
                              for v in (x_t, wqkv, bqkv, wproj, bproj)]
                g_t = g.transpose(0, 1).contiguous()
                with torch.enable_grad():
                    out_c, _ = comp_graph(False)
                    out_lib = mha(*lib_leaves)
                times = {
                    "proj library": quick(lambda: torch.autograd.grad(
                        out_lib, lib_leaves, g_t, retain_graph=True),
                        grad=True),
                    "proj": quick(lambda: cp.attn_proj_bwd(
                        x, wqkv, bqkv, wproj, dense, m, o_att, ms_, g, scale,
                        nh)),
                    "proj plain": quick(
                        lambda: cp.proj_attention_backward_reference(
                            x, wqkv, bqkv, wproj, dense, m, o_att, ms_, g,
                            scale, nh)),
                    "proj composition": quick(lambda: torch.autograd.grad(
                        out_c, leaves, g, retain_graph=True), grad=True)}
                del out_c, out_lib, lib_leaves, g_t
                nbytes = (4 * m_rows * c + ms_.numel() + 2 * small) * 4
                tot["proj_bwd"].add(
                    sites, ms=times["proj"][0], device_ms=times["proj"][1],
                    library_ms=times["proj library"][0],
                    library_device_ms=times["proj library"][1],
                    plain_ms=times["proj plain"][0],
                    plain_device_ms=times["proj plain"][1], bytes=nbytes,
                    flops=bflops)
                add_composition("proj_bwd", sites,
                                times["proj composition"][1])
                for gy in (gy_full, None):
                    args = (x, gm, bt, eps, wqkv, bqkv, wproj, dense, m,
                            o_att_ln, ms_ln, g, gy, scale, nh)
                    got = cp.attn_ln_proj_bwd(*args)
                    want = cp.ln_proj_attention_backward_reference(*args)
                    what = f"attn_ln_proj bwd {tag} gy={gy is not None}"
                    e_ln = max(check_scaled(f"{what} {nm}", p_, q_,
                                            PROJ_BWD_TOL)
                               for nm, p_, q_ in zip(ln_bwd_names, got, want))
                    again = cp.attn_ln_proj_bwd(*args)
                    if not all(torch.equal(a, b) for a, b in zip(again, got)):
                        raise AssertionError(f"{what}: two runs differ")
                    tot["ln_proj_bwd"].err = max(tot["ln_proj_bwd"].err, e_ln)
                    err = max(err, e_ln)
                    del got, want, again
                    with torch.enable_grad():
                        out_c, y_c = comp_graph(True)
                    outs, cots = ([out_c, y_c], [g, gy]) if gy is not None \
                        else ([out_c], [g])
                    lv = leaves + [gm_l, bt_l]
                    key = f"ln_proj gy={gy is not None}"
                    times[key] = quick(lambda: cp.attn_ln_proj_bwd(*args))
                    times[key + " plain"] = quick(
                        lambda: cp.ln_proj_attention_backward_reference(*args))
                    times[key + " composition"] = quick(
                        lambda: torch.autograd.grad(outs, lv, cots,
                                                    retain_graph=True),
                        grad=True)
                    del out_c, y_c, outs
                    # the tap's cotangent exists at the chosen blocks,
                    # stages 3 and 4
                    if (gy is not None) == (stage >= 2):
                        tot["ln_proj_bwd"].add(
                            sites, ms=times[key][0], device_ms=times[key][1],
                            plain_ms=times[key + " plain"][0],
                            plain_device_ms=times[key + " plain"][1],
                            bytes=nbytes + ((1 if gy is not None else 0)
                                            * m_rows * c + 4 * c) * 4,
                            flops=bflops + 20 * m_rows * c)
                        add_composition("ln_proj_bwd", sites,
                                        times[key + " composition"][1])
                _report(f"attn_proj / attn_ln_proj bwd {tag}", err, times)
                del leaves, o_att, ms_, o_att_ln, ms_ln, am, x_t, want_out
            del x, g, gy_full

    src, ops = "vitta_tpu_torch/csrc/attention_proj.cu", \
        "vitta_tpu/ops/pallas_attention.py"
    rows = [tot["proj_fwd"].row("attn_proj_fwd", src, f"{ops}:724"),
            tot["proj_bwd"].row("attn_proj_bwd", src, f"{ops}:747"),
            tot["ln_proj_fwd"].row("attn_ln_proj_fwd", src, f"{ops}:945",
                                   False),
            tot["ln_proj_bwd"].row("attn_ln_proj_bwd", src, f"{ops}:967",
                                   False)]
    for r, key in zip(rows, ("proj_fwd", "proj_bwd", "ln_proj_fwd",
                             "ln_proj_bwd")):
        r["composition_device_ms"] = comp[key]
        print(f"{r['name']} per Swin-B pass of 2 clips (24 launches): event "
              f"ms {r['ms']:.3f}, device ms {fmt(r['device_ms'])}, plain "
              f"{r['plain_ms']:.3f} (device {fmt(r['plain_device_ms'])}), "
              + ("library none" if "ln_proj" in r["name"] else
                 f"library {r['library_ms']:.3f} (device "
                 f"{fmt(r['library_device_ms'])})")
              + f", the composition it replaces device "
              f"{fmt(comp[key])}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}", flush=True)
    return rows


def phase_unfused_kernels(dev):
    """The MLP kernels without the LayerNorm and the attention kernels per
    (head, window) against their plain versions, forward and backward, at
    every Swin-T and every Swin-B stage shape for 2 clips, the attention
    with and without mask and on q, k, v as views of a packed projection
    output, as the model hands them over; two runs of each backward must
    be bit-equal.  Returns their JSON rows, whose times are sums over the
    sites of one forward or backward pass of Swin-T on 2 clips: the MLP at
    the 4 blocks of stages 1 and 2 (widths 96 and 192, the ones the model
    sends to these kernels), the attention at all 12 blocks.  Timed beside
    the MLP is the composition ``F.linear``-``F.gelu``-``F.linear`` (which
    is its plain version) and that composition's backward under autograd;
    beside the attention ``scaled_dot_product_attention`` on the same
    views with attn_mask = bias + mask made outside the timed call, and its
    backward, which gives no bias gradient."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_mlp as cm
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def quick(fn, grad=False):
        return measure(fn, reps=5, dev_reps=3, grad=grad)

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    tot = {k: Totals() for k in ("mlp_fwd", "mlp_bwd", "heads_fwd",
                                 "heads_bwd")}
    swin_b_heads = {"heads_fwd": 0.0, "heads_bwd": 0.0}   # device ms, 24 sites
    models = (("swin-T", SWIN_T_STAGES), ("swin-B", SWIN_STAGES))

    # rows 8 and 9: the MLP without the LayerNorm
    grads = ("dx", "dw1", "db1", "dw2", "db2")
    for model, stages in models:
        for stage, (c, _nh, tokens, _nw, depth) in enumerate(stages):
            f, m_rows = 4 * c, 2 * tokens
            w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
            w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
            x, g = randn(m_rows, c, scale=1.5), randn(m_rows, c)
            got = cm.mlp_fwd_cuda(x, w1, b1, w2, b2, save_residuals=True)
            want = cm.mlp_reference(x, w1, b1, w2, b2, save_residuals=True)
            tag = f"{model} M={m_rows} C={c} F={f}"
            err = max(check_close(f"mlp fwd {tag} {nm}", p, q, MLP_TOL)
                      for nm, p, q in zip(("o", "a", "s"), got, want))
            if not torch.equal(cm.mlp_fwd_cuda(x, w1, b1, w2, b2), got[0]):
                raise AssertionError(f"mlp fwd {tag}: o differs without the "
                                     "residuals")
            _o, a, s_ = got
            del got, want, _o
            args = (x, a, s_, g, w1, w2)
            got = cm.mlp_bwd_cuda(*args)
            want = cm.mlp_backward_reference(*args)
            err_b = max(check_scaled(f"mlp bwd {tag} {nm}", p, q, MLP_BWD_TOL)
                        for nm, p, q in zip(grads, got, want))
            if not all(torch.equal(p, q)
                       for p, q in zip(cm.mlp_bwd_cuda(*args), got)):
                raise AssertionError(f"mlp bwd {tag}: two runs differ")
            del got, want
            leaves = [v.detach().clone().requires_grad_()
                      for v in (x, w1, b1, w2, b2)]
            with torch.enable_grad():
                o_lib = cm.mlp_reference(*leaves)
            t = {"fwd": quick(lambda: cm.mlp_fwd_cuda(x, w1, b1, w2, b2)),
                 "fwd keeping a, s": quick(lambda: cm.mlp_fwd_cuda(
                     x, w1, b1, w2, b2, save_residuals=True)),
                 "fwd plain (F.linear-gelu-F.linear)": quick(
                     lambda: cm.mlp_reference(x, w1, b1, w2, b2)),
                 "bwd": quick(lambda: cm.mlp_bwd_cuda(*args)),
                 "bwd plain": quick(
                     lambda: cm.mlp_backward_reference(*args)),
                 "bwd of the composition": quick(
                     lambda: torch.autograd.grad(o_lib, leaves, g,
                                                 retain_graph=True),
                     grad=True)}
            _report(f"mlp {tag}", max(err, err_b), t)
            flops = 4 * m_rows * c * f + 10 * m_rows * f
            bflops = 8 * m_rows * c * f + 4 * m_rows * f
            for d, fl in (("fwd", flops), ("bwd", bflops)):
                if t[d][1]:
                    print(f"  {d} kernel rate: {fl / t[d][1] / 1e9:.1f} "
                          "TFLOP/s float32 (operations over device time)",
                          flush=True)
            tot["mlp_fwd"].err = max(tot["mlp_fwd"].err, err)
            tot["mlp_bwd"].err = max(tot["mlp_bwd"].err, err_b)
            # the sites of the model's path: Swin-T's stages 1 and 2
            if model == "swin-T" and stage < 2:
                plain = t["fwd plain (F.linear-gelu-F.linear)"]
                tot["mlp_fwd"].add(
                    depth, ms=t["fwd"][0], device_ms=t["fwd"][1],
                    plain_ms=plain[0], plain_device_ms=plain[1],
                    bytes=(2 * m_rows * c + 2 * c * f + f + c) * 4,
                    flops=flops)
                tot["mlp_bwd"].add(
                    depth, ms=t["bwd"][0], device_ms=t["bwd"][1],
                    plain_ms=t["bwd plain"][0],
                    plain_device_ms=t["bwd plain"][1],
                    library_ms=t["bwd of the composition"][0],
                    library_device_ms=t["bwd of the composition"][1],
                    bytes=(3 * m_rows * c + 2 * m_rows * f + 4 * c * f + f
                           + c) * 4, flops=bflops)
            del x, g, a, s_, args, leaves, o_lib

    # rows 12 and 13: the attention per (head, window)
    for model, stages in models:
        for c, nh, tokens, nw, depth in stages:
            hd = c // nh
            scale = hd ** -0.5
            dense = cb.expand_bias_reference(
                randn(nh, 2 * wd - 1, hw, hw), wd)
            mask = None
            if nw > 1:
                mask = torch.where(
                    torch.rand(nw, n_tok, n_tok, device=dev,
                               generator=gen) < 0.3, -100.0, 0.0)
                mask.diagonal(dim1=1, dim2=2).zero_()
            b_ = 2 * tokens // n_tok
            qkv = randn(b_, n_tok, 3 * c)
            q, k, v = qkv.reshape(b_, n_tok, 3, nh, hd).unbind(2)
            g = randn(b_, n_tok, nh, hd)
            for m in ((None, mask) if mask is not None else (None,)):
                tag = (f"{model} B_={b_} N={n_tok} nh={nh} hd={hd} mask="
                       f"{m is not None}")
                want = ca.attention_reference(q, k, v, dense, m, scale)
                err = check_close(f"attention (heads) fwd {tag}",
                                  ca.attn_heads_fwd_cuda(q, k, v, dense, m,
                                                         scale),
                                  want, ATTN_TOL)
                del want
                # the backward reads the row maximum and sum its forward
                # kept; the plain version rebuilds them from the logits
                _o, ms_h = ca.attn_heads_fwd_cuda(q, k, v, dense, m, scale,
                                                  save_ms=True)
                got = ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_h, g, scale)
                want = ca.heads_attention_backward_reference(q, k, v, dense,
                                                             m, g, scale)
                err_b = max(check_scaled(f"attention (heads) bwd {tag} {nm}",
                                         p_, q_, ATTN_BWD_TOL)
                            for nm, p_, q_ in zip(("dq", "dk", "dv", "dbias"),
                                                  got, want))
                again = ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_h, g,
                                               scale)
                if not all(torch.equal(p_, q_) for p_, q_ in zip(again, got)):
                    raise AssertionError(f"attention (heads) bwd {tag}: two "
                                         "runs differ")
                del got, want, again, _o
                launches = check_attn_bwd_launches(
                    f"attention (heads) bwd {tag}",
                    lambda: ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_h, g,
                                                   scale),
                    ca.bwd_split(b_, nh, dev))
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                leaves = [q5[i].detach().requires_grad_() for i in range(3)]
                am = dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)
                with torch.enable_grad():
                    o_lib = F.scaled_dot_product_attention(
                        *leaves, attn_mask=am, scale=scale)
                g4 = g.permute(0, 2, 1, 3)
                t = {"fwd": quick(lambda: ca.attn_heads_fwd_cuda(
                         q, k, v, dense, m, scale)),
                     "fwd plain": quick(lambda: ca.attention_reference(
                         q, k, v, dense, m, scale)),
                     "fwd sdpa": quick(
                         lambda: F.scaled_dot_product_attention(
                             q5[0], q5[1], q5[2], attn_mask=am, scale=scale)),
                     "bwd": quick(lambda: ca.attn_heads_bwd_cuda(
                         q, k, v, dense, m, ms_h, g, scale)),
                     "bwd plain": quick(
                         lambda: ca.heads_attention_backward_reference(
                             q, k, v, dense, m, g, scale)),
                     "bwd sdpa": quick(lambda: torch.autograd.grad(
                         o_lib, leaves, g4, retain_graph=True), grad=True)}
                _report(f"attention (heads) {tag}, backward {launches} "
                        "launches, none of the forward kernel",
                        max(err, err_b), t)
                tot["heads_fwd"].err = max(tot["heads_fwd"].err, err)
                tot["heads_bwd"].err = max(tot["heads_bwd"].err, err_b)
                # shifted blocks are every second one where there is a mask
                sites = depth // 2 if mask is not None else depth
                if model == "swin-B":
                    for d in ("fwd", "bwd"):
                        key = f"heads_{d}"
                        swin_b_heads[key] = None if (
                            t[d][1] is None or swin_b_heads[key] is None) \
                            else swin_b_heads[key] + sites * t[d][1]
                    del leaves, am, o_lib, ms_h
                    continue
                small = dense.numel() + (0 if m is None else m.numel())
                pairs = b_ * nh * n_tok * n_tok
                tot["heads_fwd"].add(
                    sites, ms=t["fwd"][0], device_ms=t["fwd"][1],
                    plain_ms=t["fwd plain"][0],
                    plain_device_ms=t["fwd plain"][1],
                    library_ms=t["fwd sdpa"][0],
                    library_device_ms=t["fwd sdpa"][1],
                    bytes=(4 * b_ * n_tok * c + small) * 4,
                    flops=pairs * (4 * hd + 6))
                tot["heads_bwd"].add(
                    sites, ms=t["bwd"][0], device_ms=t["bwd"][1],
                    plain_ms=t["bwd plain"][0],
                    plain_device_ms=t["bwd plain"][1],
                    library_ms=t["bwd sdpa"][0],
                    library_device_ms=t["bwd sdpa"][1],
                    bytes=(7 * b_ * n_tok * c + ms_h.numel() + small
                           + dense.numel()) * 4,
                    flops=pairs * (10 * hd + 12), tc_flops=pairs * 10 * hd)
                del leaves, am, o_lib, ms_h
            del qkv, q, k, v, g

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [tot["mlp_fwd"].row("mlp_fwd", f"{src}/mlp.cu",
                               f"{ops}/pallas_mlp.py:138", has_library=False),
            tot["mlp_bwd"].row("mlp_bwd", f"{src}/mlp.cu",
                               f"{ops}/pallas_mlp.py:154", has_library=False),
            tot["heads_fwd"].row("attn_heads_fwd", f"{src}/attention.cu",
                                 f"{ops}/pallas_attention.py:83"),
            tot["heads_bwd"].row("attn_heads_bwd", f"{src}/attention.cu",
                                 f"{ops}/pallas_attention.py:91")]
    # no one PyTorch call computes the MLP: its forward composition is the
    # plain version, its backward composition is kept beside the row
    rows[0]["composition_device_ms"] = rows[0]["plain_device_ms"]
    rows[1]["composition_device_ms"] = tot["mlp_bwd"].sum["library_device_ms"]
    rows[2]["swin_b_device_ms"] = swin_b_heads["heads_fwd"]
    rows[3]["swin_b_device_ms"] = swin_b_heads["heads_bwd"]
    fwd, bwd = swin_launches("heads", 96, (2, 2, 6, 2))
    per_pass = {**fwd, **bwd}
    for r in rows:
        extra = (f", the composition device "
                 f"{fmt(r['composition_device_ms'])}"
                 if "composition_device_ms" in r else
                 f", at Swin-B's 24 blocks device "
                 f"{fmt(r['swin_b_device_ms'])}")
        print(f"{r['name']} per Swin-T pass of 2 clips "
              f"({per_pass[r['name']]} launches): event ms {r['ms']:.3f}, "
              f"device ms {fmt(r['device_ms'])}, plain {r['plain_ms']:.3f} "
              f"(device {fmt(r['plain_device_ms'])}), library "
              f"{fmt(r['library_ms'])} (device "
              f"{fmt(r['library_device_ms'])}){extra}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}{_floor(r)}",
              flush=True)
    return rows


def phase_bn_stats_kernels(dev):
    """The BatchNorm-statistics kernels against plain on the card, forward
    and backward with cotangents on y, m and v, ``relu`` False and True, at
    every BatchNorm2d shape a TANet mean_var step reads and the two
    BatchNorm1d shapes of a TAM; returns the two JSON rows, their times
    summed over one adapt pass (``relu=False``, the form ``BatchNorm``
    calls).  No one PyTorch call returns y and the statistics: the
    composition ``F.batch_norm`` (eval form) + ``torch.var_mean`` and its
    backward under autograd are timed beside the kernels."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_stats
    from vitta_tpu_torch.ops.cuda_stats import (
        bn_stats_bwd_cuda, bn_stats_fwd_cuda, fused_bn_relu_stats,
        fused_bn_relu_stats_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=gen)

    def value_and_grads(fn, relu, x, scale, bias, mean, var, cots):
        ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y, (m, v) = fn(*ins, mean, var, relu=relu)
        torch.autograd.backward((y, m, v), cots)
        return [y.detach(), m.detach(), v.detach()] + [t.grad for t in ins]

    fwd, bwd = Totals(), Totals()
    comp = dict.fromkeys(("fwd", "bwd", "fwd_device", "bwd_device"), 0.0)
    shapes = [((r, c), n, f"{r}x{c}") for (r, c), n in BN_SITES.items()]
    shapes += [(shape, 0, name) for shape, name in BN1D_SHAPES]
    for shape, sites, label in shapes:
        c = shape[-1]
        x = rand(*shape) * 2.0 + 0.5
        scale, bias = torch.rand(c, device=dev, generator=gen) + 0.5, rand(c)
        mean = rand(c) * 0.1
        var = torch.rand(c, device=dev, generator=gen) + 0.5
        cots = (rand(*shape), rand(c), rand(c))
        for relu in (False, True):
            cuda_stats.counters.reset()
            got = value_and_grads(fused_bn_relu_stats, relu, x, scale, bias,
                                  mean, var, cots)
            again = value_and_grads(fused_bn_relu_stats, relu, x, scale, bias,
                                    mean, var, cots)
            if (cuda_stats.counters.fwd, cuda_stats.counters.bwd) != (2, 2):
                raise AssertionError("bn_stats: a call did not launch")
            want = value_and_grads(fused_bn_relu_stats_reference, relu, x,
                                   scale, bias, mean, var, cots)
            torch.cuda.synchronize()
            what = f"bn_stats {label} relu={relu}"
            e_f = max(check_close(f"{what} y", got[0], want[0], BN_TOL),
                      check_close(f"{what} m", got[1], want[1], BN_TOL, 1e-6),
                      check_close(f"{what} v", got[2], want[2], 1e-4, 1e-5))
            e_b = max(check_scaled(f"{what} {n}", g, w, BN_BWD_TOL)
                      for n, g, w in zip(("dx", "dscale", "dbias"), got[3:],
                                         want[3:]))
            for n, a, b in zip(("y", "m", "v", "dx", "dscale", "dbias"), got,
                               again):
                if not torch.equal(a, b):
                    raise AssertionError(f"{what}: two runs differ in {n}")
            fwd.err, bwd.err = max(fwd.err, e_f), max(bwd.err, e_b)
            if sites == 0 or relu:
                print(f"{what}: max abs err fwd {e_f:.2e} bwd {e_b:.2e}, two "
                      "runs bit-equal", flush=True)
        if sites == 0:
            continue
        x2 = x.reshape(-1, c)
        m = bn_stats_fwd_cuda(x2, scale, bias, mean, var, 1e-5, False)[1]
        ref_in = [t.clone().requires_grad_() for t in (x2, scale, bias)]
        ref_y, (ref_m, ref_v) = fused_bn_relu_stats_reference(
            *ref_in, mean, var, relu=False)

        def composition(xi, wi, bi):
            y = F.batch_norm(xi, mean, var, wi, bi, False, 0.0, 1e-5)
            v, mm = torch.var_mean(y, dim=0, unbiased=False)
            return y, mm, v

        comp_out = composition(*ref_in)
        with torch.no_grad():
            check_close(f"bn_stats {label} composition", comp_out[0], ref_y,
                        1e-4)
        calls = {
            "fwd": (lambda: bn_stats_fwd_cuda(x2, scale, bias, mean, var,
                                              1e-5, False), False),
            "bwd": (lambda: bn_stats_bwd_cuda(x2, scale, bias, mean, var, m,
                                              *cots, 1e-5, False), False),
            "plain_fwd": (lambda: fused_bn_relu_stats_reference(
                x2, scale, bias, mean, var, relu=False), False),
            "plain_bwd": (lambda: torch.autograd.grad(
                (ref_y, ref_m, ref_v), ref_in, cots, retain_graph=True), True),
            "comp_fwd": (lambda: composition(x2, scale, bias), False),
            "comp_bwd": (lambda: torch.autograd.grad(
                comp_out, ref_in, cots, retain_graph=True), True)}
        t = {k: measure(fn, reps=6, dev_reps=4, grad=grad)
             for k, (fn, grad) in calls.items()}
        _report(f"bn_stats {label} ({sites} sites)", max(e_f, e_b), t)
        n = x.numel()
        fwd.add(sites, ms=t["fwd"][0], plain_ms=t["plain_fwd"][0],
                device_ms=t["fwd"][1], plain_device_ms=t["plain_fwd"][1],
                bytes=(2 * n + 6 * c) * 4, flops=6 * n)
        bwd.add(sites, ms=t["bwd"][0], plain_ms=t["plain_bwd"][0],
                device_ms=t["bwd"][1], plain_device_ms=t["plain_bwd"][1],
                bytes=(3 * n + 10 * c) * 4, flops=12 * n)
        for d in ("fwd", "bwd"):
            comp[d] += sites * t[f"comp_{d}"][0]
            dv = t[f"comp_{d}"][1]
            comp[f"{d}_device"] = (None if dv is None
                                   or comp[f"{d}_device"] is None
                                   else comp[f"{d}_device"] + sites * dv)
        del x, x2, cots, ref_in, ref_y, comp_out, got, again, want
    rows = []
    for d, tot in (("fwd", fwd), ("bwd", bwd)):
        # the TPU function has no backward: both rows stand for its one site
        row = tot.row(f"bn_stats_{d}", "vitta_tpu_torch/csrc/bn_stats.cu",
                      "vitta_tpu/ops/pallas_stats.py:68", has_library=False)
        row["composition_ms"] = comp[d]
        row["composition_device_ms"] = comp[f"{d}_device"]
        rows.append(row)
        print(f"bn_stats_{d} per TANet adapt pass (29 sites, relu=False): "
              f"device ms kernel {fmt(row['device_ms'])} plain "
              f"{fmt(row['plain_device_ms'])} composition (F.batch_norm + "
              f"torch.var_mean{', autograd' if d == 'bwd' else ''}) "
              f"{fmt(row['composition_device_ms'])}; event ms {row['ms']:.4f} "
              f"/ {row['plain_ms']:.4f} / {row['composition_ms']:.4f}; library"
              f" call: none (no one PyTorch call returns y and the "
              f"statistics); bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}", flush=True)
    return rows


def _assert_updates_agree(what, sd, p_gpu, p_cpu, rel):
    """Each parameter's update from ``sd`` on the card against the CPU's, to
    ``rel`` of its norm; returns the worst ratio and how many moved."""
    worst, moved = 0.0, 0
    for k, p in p_cpu.items():
        dg, dc = p_gpu[k] - sd[k], p - sd[k]
        diff, norm = float((dg - dc).norm()), float(dc.norm())
        if diff > rel * norm + 1e-8:
            raise AssertionError(f"{what}: update of {k}: card and cpu differ "
                                 f"by {diff / (norm + 1e-12):.3e} of its norm")
        worst = max(worst, diff / (norm + 1e-12))
        moved += norm > 0
    return worst, moved


def phase_small_slice(seed, what="small slice", tta=None, optim=None,
                      epoch=False, rel=2e-2):
    """Two tta_online steps at T=2, 32x32 on the card and on the CPU, under
    the ``tta`` and ``optim`` overrides; with ``epoch`` the epoch-style
    loop (two adapt-only steps, then one evaluation pass) instead.

    Tolerances: losses and the EMA rtol 1e-3 / atol 1e-5 and eval logits
    rtol 2e-3 / atol 2e-4 (cuDNN and oneDNN float32 convs sum in different
    orders; tests/test_tanet_parity.py's bound); lr is raised to 1e-2 so
    that the weight updates stand far above float32 rounding, and each
    tensor's update agrees to ``rel`` (2%) of its norm.  Under Adam an
    element whose gradient is rounding noise moves by lr in either
    direction, so that slice runs at lr 1e-3 and 10%."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_epoch_adapt
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.ops import cuda_stats
    cfg = _cfg(2, 101, tta=tta, optim={"lr": 1e-2, **(optim or {})},
               dropout=0.0)
    torch.manual_seed(seed)
    model = get_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    src = _tanet_source(model, torch.from_numpy(
        rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)),
        cfg.tta.stat_reg)
    videos = _videos(rng, 2, 2, 32)
    cuda_stats.counters.reset()
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = VittaEngine(get_model(cfg), cfg, sd, src, device=dev)
        metrics = []
        if epoch:
            top1, state = tta_epoch_adapt(
                eng, videos, [(c, l) for _v, c, l in videos], seed=seed)
            metrics.append({"top1": top1})
        else:
            state = eng.init_state()
            for views, clip, label in videos:
                state, m = eng.adapt_eval_step(state, views, clip, label)
                metrics.append({f: float(getattr(m, f)) for f in
                                ("loss_reg", "loss_consis", "loss_ce")})
        if state.step != len(videos):
            raise AssertionError(f"{what}: {state.step} steps")
        logits = eng.eval_logits(videos[-1][1]).cpu()
        params = {k: p.detach().cpu() for k, p in eng.model.named_parameters()}
        runs[dev] = (metrics, logits, params,
                     {k: (v.mean.cpu(), v.var.cpu())
                      for k, v in state.ema.items()})
    bn_launches = (cuda_stats.counters.fwd, cuda_stats.counters.bwd)
    (m_gpu, l_gpu, p_gpu, e_gpu), (m_cpu, l_cpu, p_cpu, e_cpu) = (
        runs["cuda"], runs["cpu"])
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for f in a:
            if not abs(a[f] - b[f]) <= 1e-5 + 1e-3 * abs(b[f]):
                raise AssertionError(f"{what}: step {i} {f}: card {a[f]} cpu "
                                     f"{b[f]}")
    logit_err = check_close(f"{what} eval logits", l_gpu, l_cpu, 2e-3, 2e-4)
    if not e_cpu:
        raise AssertionError(f"{what}: no layer was chosen")
    ema_err = max(check_close(f"{what} ema {k}", g, c, 1e-3, 1e-5)
                  for k in e_cpu for g, c in zip(e_gpu[k], e_cpu[k]))
    worst, moved = _assert_updates_agree(what, sd, p_gpu, p_cpu, rel)
    if moved == 0:
        raise AssertionError(f"{what}: no parameter moved")
    print(f"{what} card vs cpu: {m_gpu} vs {m_cpu}; eval logits max abs err "
          f"{logit_err:.2e}; EMA of {len(e_cpu)} layers max abs err "
          f"{ema_err:.2e}; {moved} parameters moved, worst update difference "
          f"{worst:.2e} of its norm; bn_stats launches fwd/bwd {bn_launches}",
          flush=True)
    return bn_launches


def phase_full_slice(seed, n_videos, card, tta=None, what="mean_var",
                     warmup=2, epoch=False):
    """TANet at the reference operating point over seeded videos, under the
    ``tta`` overrides: ``tta_stream``, or with ``epoch`` ``tta_epoch_adapt``
    (adapt-only steps, then one ``validate`` pass).  Returns the launch
    counts of the run and a summary of its times."""
    from vitta_tpu_torch.adapt.loops import tta_epoch_adapt, tta_stream
    from vitta_tpu_torch.ops import cuda_stats, cuda_tam
    cfg = _cfg(16, 101, tta=tta)
    engine, rng = _tanet_engine(cfg, seed)
    videos = _videos(rng, n_videos, 16, 224)
    chosen = len(engine.tap_names)
    writer = _StepTimes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_tam.counters.reset()
    cuda_stats.counters.reset()
    t0 = time.perf_counter()
    if epoch:
        top1, state = tta_epoch_adapt(
            engine, videos, [(c, l) for _v, c, l in videos], seed=seed)
        meters = None
    else:
        top1, state, meters = tta_stream(engine, videos, seed=seed,
                                         metrics_writer=writer)
        top1 = top1[0]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {"tam_fwd": cuda_tam.counters.fwd,
              "tam_bwd": cuda_tam.counters.bwd,
              "bn_stats_fwd": cuda_stats.counters.fwd,
              "bn_stats_bwd": cuda_stats.counters.bwd}
    grad_copies = cuda_tam.counters.grad_copies
    peak = torch.cuda.max_memory_allocated()

    if meters is not None:
        for k in ("loss_reg", "loss_consis", "loss_ce"):
            if not np.isfinite(meters[k].avg):
                raise AssertionError(f"{what}: {k} is not finite: "
                                     f"{meters[k].avg}")
        if not meters["loss_reg"].avg > 0:
            raise AssertionError(f"{what}: the regularization loss is 0")
    if state.step != n_videos:
        raise AssertionError(f"{state.step} steps for {n_videos} videos")
    for k, p in engine.model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{what}: {k} is not finite")
    moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                for k, p in engine.model.named_parameters())
    if moved == 0:
        raise AssertionError("no parameter changed")
    ema_norm = sum(float(s.mean.abs().sum() + s.var.abs().sum())
                   for s in state.ema.values())
    if not (np.isfinite(ema_norm) and ema_norm > 0):
        raise AssertionError(f"EMA did not move (sum |ema| = {ema_norm})")
    # per video: the adapt forward (16 TAM sites) and the eval forward (16),
    # one backward.  The BatchNorm-statistics kernel runs where a step reads
    # a BatchNorm's output-side spatiotemp leaf: at every chosen layer of a
    # mean_var step, forward and backward, never in the untapped eval
    # forward, and not under BNS (input side) or cossim (another leaf).
    reads_stat = cfg.tta.stat_reg == "mean_var" and not cfg.tta.before_norm
    bn = chosen * n_videos if reads_stat else 0
    want = {"tam_fwd": 32 * n_videos, "tam_bwd": 16 * n_videos,
            "bn_stats_fwd": bn, "bn_stats_bwd": bn}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} "
                             f"({chosen} chosen layers)")
    ms = writer.ms[warmup:] if writer.ms else [wall_ms / n_videos]
    summary = {"mode": what, "videos": len(ms), "chosen": chosen,
               "median_ms": statistics.median(ms), "min_ms": min(ms),
               "max_ms": max(ms), "peak_gib": peak / 2**30}
    losses = ("" if meters is None else
              f"losses reg {meters['loss_reg'].avg:.5f} consis "
              f"{meters['loss_consis'].avg:.5f} ce "
              f"{meters['loss_ce'].avg:.5f}, ")
    print(f"full slice ({what}): {n_videos} videos, {chosen} chosen layers, "
          + (f"{wall_ms / n_videos:.3f} ms/video over the adapt-only steps "
             f"and the evaluation pass (no warm-up apart)" if epoch else
             f"median {summary['median_ms']:.3f} ms/video after {warmup} "
             f"warm-up")
          + f" (host clock, synchronised on the metrics; includes the uint8 "
          f"host-to-device copy), peak memory {peak / 2**30:.3f} GiB, {moved} "
          f"parameter tensors moved, {losses}top1 {top1:.1f}; launches "
          f"{counts}, gradient contiguity copies {grad_copies}; on {card}",
          flush=True)

    # where the time goes: one adapt+eval step with its inputs on the card
    host_ms, busy, classes, largest = _profile_step(engine, videos[-1], state)
    if busy == 0:
        print(f"TANet adapt step ({what}): device time not measured",
              flush=True)
    else:
        summary.update(host_ms=host_ms, device_busy_ms=busy,
                       idle_share=max(0.0, 1 - busy / host_ms),
                       classes=classes)
        print(f"TANet adapt step ({what}), profiled: host {host_ms:.3f} ms, "
              f"device busy {busy:.3f} ms, idle share "
              f"{summary['idle_share']:.2f}; by class, ms (launches): "
              + ", ".join(f"{k} {v[0]:.3f} ({v[1]})"
                          for k, v in classes.items())
              + "; largest kernels: "
              + "; ".join(f"{k[:50]} {t:.3f} ms x{n}" for k, t, n in largest[:6]),
              flush=True)
    return counts, summary


# ---------------------------------------------------------------------------
def _swin_model(cfg, sd, attn_route=None):
    from vitta_tpu_torch.models import get_model
    model = get_model(cfg, attn_route=attn_route)
    model.load_state_dict(sd, strict=True)
    return model


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
    from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                     cuda_bias, cuda_ln, cuda_mlp)
    proj = cuda_attention_proj.counters
    return {"ln_fwd": cuda_ln.counters.fwd,
            "bias_expand": cuda_bias.counters.fwd,
            "attn_packed_fwd": cuda_attention.counters.fwd,
            "attn_heads_fwd": cuda_attention.counters.heads_fwd,
            "attn_proj_fwd": proj.proj_fwd,
            "attn_ln_proj_fwd": proj.ln_proj_fwd,
            "ln_mlp_fwd": cuda_mlp.counters.fwd,
            "mlp_fwd": cuda_mlp.counters.mlp_fwd,
            "ln_bwd": cuda_ln.counters.bwd,
            "bias_collapse": cuda_bias.counters.bwd,
            "attn_packed_bwd": cuda_attention.counters.bwd,
            "attn_heads_bwd": cuda_attention.counters.heads_bwd,
            "attn_proj_bwd": proj.proj_bwd,
            "attn_ln_proj_bwd": proj.ln_proj_bwd,
            "ln_mlp_bwd": cuda_mlp.counters.bwd,
            "mlp_bwd": cuda_mlp.counters.mlp_bwd,
            "contiguity_copies": swin.counters.contiguity_copies}


def _reset_swin_counts():
    from vitta_tpu_torch.models import swin
    from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                     cuda_bias, cuda_ln, cuda_mlp)
    for mod in (cuda_ln, cuda_bias, cuda_attention, cuda_attention_proj,
                cuda_mlp, swin):
        mod.counters.reset()


def swin_launches(route, embed_dim=128, depths=(2, 2, 18, 2)):
    """(forward, backward) launches per pass, by kernel, of a Swin of this
    width and these depths (the defaults are Swin-B's) whose blocks all
    take ``route`` (None: the packed default) on full windows.  A stage
    whose width is a multiple of 128 runs norm2 inside the LayerNorm-MLP
    kernel, any other as a LayerNorm launch of its own in front of the MLP
    kernel (``dispatch.mlp_ln_fused``; the token counts of a 16x224x224
    clip are multiples of 8 at every stage).  Outside the blocks there is
    one LayerNorm per stage (patch embed, PatchMerging) and the final one."""
    attn = {None: "attn_packed", "packed": "attn_packed", "proj": "attn_proj",
            "ln_proj": "attn_ln_proj", "heads": "attn_heads"}[route]
    blocks = sum(depths)
    fused = sum(d for i, d in enumerate(depths)
                if (embed_dim << i) % 128 == 0)
    norms = (len(depths) + 1 + (0 if route == "ln_proj" else blocks)
             + blocks - fused)
    fwd = {"ln_fwd": norms, "bias_expand": blocks, "attn_packed_fwd": 0,
           "attn_heads_fwd": 0, "attn_proj_fwd": 0, "attn_ln_proj_fwd": 0,
           "ln_mlp_fwd": fused, "mlp_fwd": blocks - fused}
    bwd = {"ln_bwd": norms, "bias_collapse": blocks, "attn_packed_bwd": 0,
           "attn_heads_bwd": 0, "attn_proj_bwd": 0, "attn_ln_proj_bwd": 0,
           "ln_mlp_bwd": fused, "mlp_bwd": blocks - fused}
    fwd[attn + "_fwd"] = bwd[attn + "_bwd"] = blocks
    return fwd, bwd


def phase_swin_card_vs_cpu(what, cfg, seed, sizes, t, hw, attn_route=None):
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
        stats[dev] = compute_source_statistics(
            _swin_model(cfg, sd, attn_route), batches, device=dev)
        eng = VittaEngine(_swin_model(cfg, sd, attn_route), cfg, sd,
                          stats[dev], device=dev)
        logits[dev] = eng.eval_logits(clip).cpu()
    counts = _swin_counts()
    stat_err = _compare_stats(what, stats["cuda"], stats["cpu"], names)
    logit_err = check_close(f"{what} eval logits", logits["cuda"],
                            logits["cpu"], 2e-3, 2e-4)
    for k, n in swin_launches(attn_route, cfg.model.embed_dim,
                              cfg.model.depths)[0].items():
        if n and counts[k] == 0:
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


def phase_swin_full_slice(cfg, seed, card, attn_route=None,
                          eval_videos=SWIN_EVAL_VIDEOS, sd=None,
                          what="swin-B"):
    """The Swin of ``cfg`` (at full width and depth) through the
    source-statistics precompute and source-only evaluation under
    ``attn_route``; returns the launch counts of the run, the statistics
    as reloaded from their files, the state dict and the first video's
    eval logits."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import (
        compute_source_statistics, load_source_statistics_npz,
        save_source_statistics)
    from vitta_tpu_torch.utils.checkpoint import (load_reference_stats,
                                                  swin_norm_layers)
    arch, depths, classes = (cfg.model.arch, cfg.model.depths,
                             cfg.model.num_classes)
    t, hw = cfg.data.clip_length, cfg.data.input_size
    sd = _swin_weights(cfg, seed) if sd is None else sd
    rng = np.random.default_rng(seed)
    batches = _TimedBatches(_normalized_batches(
        rng, cfg, (2,) * SWIN_STAT_BATCHES, t, hw))
    videos = [(rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8),
               np.asarray([i % classes], np.int64))
              for i in range(eval_videos)]
    names = [n for n, _ in swin_norm_layers(depths)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    stats = compute_source_statistics(_swin_model(cfg, sd, attn_route),
                                      batches)
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

    engine = VittaEngine(_swin_model(cfg, sd, attn_route), cfg, sd, pair)
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
        for which, fn in (
                ("tapped forward of 2 clips",
                 lambda: engine.model(clips2, Taps({"stat"}), train=False)),
                ("eval forward of 1 clip",
                 lambda: engine.eval_logits(clip1))):
            host_ms, busy, rows = device_breakdown(fn)
            if busy == 0:
                print(f"{what} {which}: device time not measured",
                      flush=True)
                continue
            print(f"{what} {which}, profiled: host {host_ms:.3f} ms, device "
                  f"busy {busy:.3f} ms, idle share "
                  f"{max(0.0, 1 - busy / host_ms):.2f}; largest kernels: "
                  + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}"
                              for k, ms, n in rows), flush=True)

    forwards = SWIN_STAT_BATCHES + eval_videos + 1
    want = swin_launches(attn_route, cfg.model.embed_dim, depths)[0]
    for k, per_forward in want.items():
        if counts[k] != forwards * per_forward:
            raise AssertionError(
                f"{k}: {counts[k]} launches over {forwards} forward passes, "
                f"expected {per_forward} each")
    if counts["contiguity_copies"]:
        raise AssertionError(f"{counts['contiguity_copies']} contiguity "
                             "copies on the Swin path")
    stat_ms = batches.ms()[1:]
    print(f"{what} full slice ({attn_route or 'packed'}): source statistics "
          f"{SWIN_STAT_BATCHES} batches of "
          f"2 clips, median {statistics.median(stat_ms) / 2:.3f} ms/clip "
          f"after 1 warm-up batch (host clock, each batch synchronised on "
          f"its statistics; float32 host-to-device copy included), peak "
          f"memory {peak_stats / 2**30:.3f} GiB, {len(names)} layers written "
          f"and "
          f"reloaded; source-only eval {eval_videos} videos, median "
          f"{statistics.median(eval_ms[1:]):.3f} ms/clip after 1 warm-up "
          f"(uint8 copy and normalisation included), peak memory "
          f"{peak_eval / 2**30:.3f} GiB, predictions {preds}; launches over "
          f"{forwards} forward passes {counts}; on {card}", flush=True)
    return counts, pair, sd, logits.cpu()


def _swin_direct(cfg, sd, attn_route=None, **kw):
    """The Swin of ``cfg`` built directly, for the dropout rates that the
    configuration has no field for."""
    from vitta_tpu_torch.models.swin import Recognizer3D
    mc = cfg.model
    model = Recognizer3D(mc.num_classes, patch_size=mc.patch_size,
                         window_size=mc.window_size, embed_dim=mc.embed_dim,
                         depths=mc.depths, num_heads=mc.num_heads,
                         attn_route=attn_route, **kw)
    model.load_state_dict(sd, strict=True)
    return model


def phase_swin_adapt_small(cfg, seed, t, hw, attn_route=None,
                           what="swin adapt small slice", cossim=False):
    """Two tta_online steps of a small Swin on the card and on the CPU,
    drop-path and head dropout 0; with ``cossim`` under
    ``stat_reg="cossim"``, the relation-map targets from
    ``compute_cossim_statistics`` of one clean batch.

    Tolerances as in ``phase_small_slice``: losses rtol 1e-3 / atol 1e-5,
    eval logits rtol 2e-3 / atol 2e-4, the EMA rtol 1e-3 / atol 1e-5; lr is
    raised to 1e-3 so that the updates stand far above float32 rounding,
    and each parameter's update agrees to 2% of its norm."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import (compute_cossim_statistics,
                                                  compute_source_statistics)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=1e-3))
    kw = {}
    if cossim:
        cfg = cfg.replace(tta=dataclasses.replace(
            cfg.tta, stat_reg="cossim", stat_type=("temp",)))
        kw = dict(stat_types=cfg.tta.tap_stat_types())
    sd = _swin_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    batches = _normalized_batches(rng, cfg, (2,), t, hw)
    if cossim:
        # every norm layer relates its t / 2 token planes in time
        src = compute_cossim_statistics(
            _swin_model(cfg, sd), batches, clip_len=t, device="cpu",
            tap_filter=lambda n: "patch_embed" not in n)
    else:
        src = compute_source_statistics(_swin_model(cfg, sd), batches,
                                        device="cpu")
    videos = _videos(rng, 2, t, hw)
    _reset_swin_counts()
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = VittaEngine(_swin_direct(cfg, sd, attn_route,
                                       drop_path_rate=0.0, head_dropout=0.0,
                                       **kw),
                          cfg, sd, src, device=dev)
        state = eng.init_state()
        metrics = []
        for views, clip, label in videos:
            state, m = eng.adapt_eval_step(state, views, clip, label)
            metrics.append({f: float(getattr(m, f))
                            for f in ("loss_reg", "loss_consis", "loss_ce")})
        runs[dev] = (metrics, eng.eval_logits(videos[-1][1]).cpu(),
                     {k: p.detach().cpu()
                      for k, p in eng.model.named_parameters()},
                     {k: (v.mean.cpu(), v.var.cpu())
                      for k, v in state.ema.items()})
    counts = _swin_counts()
    (m_gpu, l_gpu, p_gpu, e_gpu), (m_cpu, l_cpu, p_cpu, e_cpu) = (
        runs["cuda"], runs["cpu"])
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for f in a:
            if not abs(a[f] - b[f]) <= 1e-5 + 1e-3 * abs(b[f]):
                raise AssertionError(f"step {i} {f}: card {a[f]} cpu {b[f]}")
    logit_err = check_close("swin adapt eval logits", l_gpu, l_cpu, 2e-3, 2e-4)
    ema_err = max(check_close(f"swin adapt ema {k}", g, c, 1e-3, 1e-5)
                  for k in e_cpu for g, c in zip(e_gpu[k], e_cpu[k]))
    worst, moved = 0.0, 0
    for k, p in p_cpu.items():
        dg, dc = p_gpu[k] - sd[k], p - sd[k]
        diff, norm = float((dg - dc).norm()), float(dc.norm())
        if diff > 2e-2 * norm + 1e-8:
            raise AssertionError(f"update of {k}: card and cpu differ by "
                                 f"{diff / (norm + 1e-12):.3e} of its norm")
        worst = max(worst, diff / (norm + 1e-12))
        moved += norm > 0
    if moved != len(p_cpu):
        raise AssertionError(f"only {moved} of {len(p_cpu)} parameters moved")
    fwd, bwd = swin_launches(attn_route, cfg.model.embed_dim,
                             cfg.model.depths)
    for k, n in {**fwd, **bwd}.items():
        if n and counts[k] == 0:
            raise AssertionError(f"{what}: the {k} kernel was never launched")
    print(f"{what} ({attn_route or 'packed'}) card vs cpu: "
          f"losses {m_gpu} vs {m_cpu}; "
          f"eval logits max abs err {logit_err:.2e}; EMA max abs err "
          f"{ema_err:.2e}; all {moved} parameters moved, worst update "
          f"difference {worst:.2e} of its norm; launches {counts}",
          flush=True)


def phase_swin_adapt_full(cfg, sd, stats, seed, card, attn_route=None,
                          n_videos=SWIN_ADAPT_VIDEOS, warmup=2,
                          what="swin-B"):
    """tta_stream of the Swin of ``cfg`` (swin_ucf101_preset, at Swin-B's
    or Swin-T's width and depth) under ``attn_route`` over seeded videos,
    drop-path 0.2 and head dropout 0.5 on; returns the launch counts of
    the run and a summary of its times."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_stream
    from vitta_tpu_torch.models import get_model
    classes = cfg.model.num_classes
    route = attn_route or "packed"
    t, hw = cfg.data.clip_length, cfg.data.input_size
    engine = VittaEngine(get_model(cfg, attn_route=attn_route), cfg, sd,
                         stats)
    if (engine.model.backbone.layers[2].blocks[-1].drop_path <= 0
            or engine.model.cls_head.dropout != 0.5):
        raise AssertionError("drop-path or head dropout is off")
    rng = np.random.default_rng(seed + 1)
    videos = _videos(rng, n_videos, t, hw)
    writer = _StepTimes()
    preds = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    top1, state, meters = tta_stream(engine, videos, seed=seed,
                                     metrics_writer=writer)
    torch.cuda.synchronize()
    counts = _swin_counts()
    peak = torch.cuda.max_memory_allocated()

    for k in ("loss_reg", "loss_consis", "loss_ce"):
        if not np.isfinite(meters[k].avg):
            raise AssertionError(f"{k} is not finite: {meters[k].avg}")
    if state.step != n_videos:
        raise AssertionError(f"{state.step} steps for {n_videos} videos")
    _reset_swin_counts()
    for clip in (videos[0][1], videos[-1][1]):
        logits = engine.eval_logits(clip)
        pred = int(torch.argmax(logits, -1)[0])
        if (tuple(logits.shape) != (1, classes) or not 0 <= pred < classes
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("eval logits after adaptation are not "
                                 f"finite (1, {classes})")
        preds.append(pred)
    if _swin_counts()["contiguity_copies"]:
        raise AssertionError(f"{what} {route}: contiguity copies in a "
                             "forward pass")
    # every parameter has a finite gradient from the last step; a block
    # whose branch drop-path dropped for both views has an exactly zero one,
    # and at lr 1e-5 an update below float32's spacing leaves a tensor as it
    # was, so "most" is asked for and the counts are printed
    params = dict(engine.model.named_parameters())
    for k, p in params.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()) \
                or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{k}: no finite gradient or value after "
                                 "adaptation")
    moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                for k, p in params.items())
    tables = [k for k in params if k.endswith("relative_position_bias_table")]
    tables_grad = sum(bool(params[k].grad.abs().max() > 0) for k in tables)
    if 4 * moved < 3 * len(params) or 4 * tables_grad < 3 * len(tables):
        raise AssertionError(
            f"{moved} of {len(params)} parameters moved and {tables_grad} of "
            f"{len(tables)} bias tables have a gradient: fewer than three in "
            "four")
    ema_norm = sum(float(s.mean.abs().sum() + s.var.abs().sum())
                   for s in state.ema.values())
    if not (np.isfinite(ema_norm) and ema_norm > 0):
        raise AssertionError(f"EMA did not move (sum |ema| = {ema_norm})")
    # per video: the adapt forward and the eval forward, one backward
    fwd, bwd = swin_launches(attn_route, cfg.model.embed_dim,
                             cfg.model.depths)
    for k, per_pass in fwd.items():
        if counts[k] != 2 * per_pass * n_videos:
            raise AssertionError(f"{what} {route} {k}: {counts[k]} launches "
                                 f"over {n_videos} videos, expected 2 x "
                                 f"{per_pass} each")
    for k, per_pass in bwd.items():
        if counts[k] != per_pass * n_videos:
            raise AssertionError(f"{what} {route} {k}: {counts[k]} launches "
                                 f"over {n_videos} videos, expected {per_pass} "
                                 "each")
    warm = writer.ms[warmup:]
    summary = {"model": what, "route": route, "videos": len(warm),
               "median_ms": statistics.median(warm), "min_ms": min(warm),
               "max_ms": max(warm), "peak_gib": peak / 2**30}
    print(f"{what} adapt full slice ({route}): {n_videos} videos, median "
          f"{statistics.median(warm):.3f} ms/video (min {min(warm):.3f}, max "
          f"{max(warm):.3f}) after {len(writer.ms) - len(warm)} warm-up (host "
          f"clock, synchronised on the metrics; includes the uint8 "
          f"host-to-device copy), peak memory {peak / 2**30:.3f} GiB, "
          f"{moved} of {len(params)} parameter tensors moved, {tables_grad} "
          f"of {len(tables)} bias tables with a gradient in the last step, "
          f"losses reg {meters['loss_reg'].avg:.5f} consis "
          f"{meters['loss_consis'].avg:.5f} ce {meters['loss_ce'].avg:.5f}, "
          f"top1 {top1[0]:.1f}, predictions {preds}; launches {counts} "
          f"({counts['contiguity_copies'] / n_videos:.1f} contiguity copies "
          f"per video); on {card}", flush=True)

    # where the time goes: one adapt+eval step with its inputs on the card
    views, clip, label = (torch.from_numpy(a).cuda() for a in videos[-1])
    box = [state]

    def step():
        box[0], _m = engine.adapt_eval_step(box[0], views, clip, label)

    host_ms, busy, rows = device_breakdown(step, top=14)
    if busy == 0:
        print(f"{what} adapt step ({route}): device time not measured",
              flush=True)
    else:
        summary.update(host_ms=host_ms, device_busy_ms=busy,
                       idle_share=max(0.0, 1 - busy / host_ms))
        print(f"{what} adapt step ({route}), profiled: host {host_ms:.3f} ms, "
              f"device busy {busy:.3f} ms, idle share "
              f"{summary['idle_share']:.2f}; largest kernels: "
              + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in rows),
              flush=True)
    return counts, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
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

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[{what}: {now - clock[0]:.1f} s]", flush=True)
        clock[0] = now

    dev = torch.device("cuda")
    tam_rows = phase_tam_kernels(dev)
    lap("phase 3, TAM kernels")
    swin_rows = phase_swin_kernels(dev)
    lap("phase 4, Swin kernels")
    proj_rows = phase_swin_proj_kernels(dev)
    lap("phase 12, projection-fused attention kernels")
    unfused_rows = phase_unfused_kernels(dev)
    lap("phase 15, MLP and per-(head, window) attention kernels")
    bn_rows = phase_bn_stats_kernels(dev)
    lap("phase 18, BatchNorm-statistics kernels")
    small_bn = phase_small_slice(SEED)
    if 0 in small_bn:
        raise AssertionError("small slice: the bn_stats kernels never ran")
    launches, tanet = phase_full_slice(SEED, N_VIDEOS, card)
    if tanet["chosen"] != 29:   # 19 BatchNorm2d in layer3 + 10 in layer4
        raise AssertionError(f"{tanet['chosen']} chosen layers, expected 29")
    lap("phases 5-6, TANet slices")
    for row in tam_rows + bn_rows:
        row["launches"] = launches[row["name"]]
    # the engine's other modes on TANet: small slices against the CPU, then
    # each at full size
    for what, kw in (
            ("BNS, running EMA", dict(tta=dict(stat_reg="BNS"))),
            ("BNS, raw batch statistics",
             dict(tta=dict(stat_reg="BNS", running_manner=False))),
            ("cossim, l1_loss",
             dict(tta=dict(stat_reg="cossim", stat_type=("temp",)))),
            ("Adam on the norm affine parameters",
             dict(optim=dict(lr=1e-3, update_only_bn_affine=True), rel=0.1)),
            ("tta_epoch_adapt", dict(epoch=True))):
        phase_small_slice(SEED, what=f"small slice ({what})", **kw)
    phase_swin_adapt_small(
        _swin_cfg(t=4, hw=24, embed_dim=8, depths=(1, 1, 2, 1),
                  num_heads=(1, 2, 4, 8), window_size=(2, 3, 3)),
        SEED, 4, 24, what="swin adapt small slice, cossim", cossim=True)
    lap("phase 19, small slices of the engine's other modes")
    tanet_modes = [tanet]
    for what, kw in (
            ("BNS", dict(tta=dict(stat_reg="BNS"))),
            ("cossim", dict(tta=dict(stat_reg="cossim",
                                     stat_type=("temp",)))),
            ("tta_epoch_adapt", dict(epoch=True))):
        _counts, summary = phase_full_slice(SEED, TANET_MODE_VIDEOS, card,
                                            what=what, warmup=1, **kw)
        tanet_modes.append(summary)
    lap("phase 20, TANet under BNS, cossim and the epoch-style loop")
    phase_swin_card_vs_cpu(
        "swin small slice", _swin_cfg(
            t=4, hw=24, embed_dim=8, depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 8), window_size=(2, 3, 3)),
        SEED, (2, 1, 2), 4, 24)
    phase_swin_card_vs_cpu("swin-B width, depths (2,2,2,1)",
                           _swin_cfg(depths=(2, 2, 2, 1)), SEED, (1,), 16, 224)
    lap("phases 7-8, Swin card against CPU")
    forward_launches, stats, sd, logits = phase_swin_full_slice(
        _swin_cfg(), SEED, card)
    lap("phase 9, Swin-B forward slice")
    tiny = dict(embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                window_size=(2, 3, 3))
    phase_swin_adapt_small(_swin_cfg(t=4, hw=24, **tiny), SEED, 4, 24)
    launches, packed = phase_swin_adapt_full(_swin_cfg(), sd, stats, SEED,
                                             card)
    lap("phases 10-11, Swin adapt slices")
    for row in swin_rows:
        # the adapt stream's count; the forward-only paths' beside it
        row["launches"] = launches[row["name"]]
        row["launches_forward_paths"] = forward_launches[row["name"]]

    # the projection-fused routes: small slices, then the full ones
    for route in ("proj", "ln_proj"):
        phase_swin_card_vs_cpu(
            f"swin small slice ({route})", _swin_cfg(t=4, hw=24, **tiny),
            SEED, (2, 1, 2), 4, 24, attn_route=route)
        phase_swin_adapt_small(_swin_cfg(t=4, hw=24, **tiny), SEED, 4, 24,
                               attn_route=route)
    lap("phase 13, small slices of the projection-fused routes")
    fused_forward, ln_stats, _sd, ln_logits = phase_swin_full_slice(
        _swin_cfg(), SEED, card, attn_route="ln_proj",
        eval_videos=SWIN_PROJ_EVAL_VIDEOS, sd=sd)
    stat_err = _compare_stats("swin ln_proj against packed", ln_stats, stats,
                              list(stats))
    logit_err = check_close("swin ln_proj against packed, eval logits",
                            ln_logits, logits, 2e-3, 2e-4)
    print(f"swin full slice, ln_proj against packed: {len(stats)} source "
          f"statistics max abs err {stat_err:.2e}, eval logits max abs err "
          f"{logit_err:.2e}", flush=True)
    ln_launches, ln_proj = phase_swin_adapt_full(
        _swin_cfg(), sd, stats, SEED, card, attn_route="ln_proj",
        n_videos=SWIN_LN_PROJ_VIDEOS, warmup=2)
    proj_launches, proj = phase_swin_adapt_full(
        _swin_cfg(), sd, stats, SEED, card, attn_route="proj",
        n_videos=SWIN_PROJ_VIDEOS, warmup=1)
    for row in proj_rows:
        by_route = ln_launches if "ln_proj" in row["name"] else proj_launches
        row["launches"] = by_route[row["name"]]
        row["launches_forward_paths"] = fused_forward[row["name"]]
    lap("phase 14, Swin-B slices of the projection-fused routes")

    # the per-(head, window) route and both branches of the MLP: small
    # slices.  embed 16 over four stages at 48 x 48 gives widths 16 to 128,
    # whose last stage runs norm2 inside the LayerNorm-MLP kernel and the
    # others apart (the embed-8 slices above take the latter at every stage)
    both = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                window_size=(2, 3, 3))
    for route, hw_, kw in (("heads", 24, tiny), ("heads", 48, both),
                           (None, 48, both)):
        name = f"embed {kw['embed_dim']} at {hw_}"
        phase_swin_card_vs_cpu(
            f"swin small slice, {name} ({route or 'packed'})",
            _swin_cfg(t=4, hw=hw_, **kw), SEED, (2, 1, 2), 4, hw_,
            attn_route=route)
        phase_swin_adapt_small(_swin_cfg(t=4, hw=hw_, **kw), SEED, 4, hw_,
                               attn_route=route,
                               what=f"swin adapt small slice, {name}")
    lap("phase 16, small slices of the heads route and both MLP branches")

    # Swin-T at full width and depth: packed, then "heads"
    cfg_t = _swin_cfg(**SWIN_MODELS["swin_t"])
    t_forward, t_stats, t_sd, t_logits = phase_swin_full_slice(
        cfg_t, SEED, card, eval_videos=SWIN_T_STAT_EVAL_VIDEOS, what="swin-T")
    t_launches, t_packed = phase_swin_adapt_full(
        cfg_t, t_sd, t_stats, SEED, card, n_videos=SWIN_T_VIDEOS,
        what="swin-T")
    th_forward, th_stats, _sd, th_logits = phase_swin_full_slice(
        cfg_t, SEED, card, attn_route="heads",
        eval_videos=SWIN_T_STAT_EVAL_VIDEOS, sd=t_sd, what="swin-T")
    stat_err = _compare_stats("swin-T heads against packed", th_stats,
                              t_stats, list(t_stats))
    logit_err = check_close("swin-T heads against packed, eval logits",
                            th_logits, t_logits, 2e-3, 2e-4)
    print(f"swin-T full slice, heads against packed: {len(t_stats)} source "
          f"statistics max abs err {stat_err:.2e}, eval logits max abs err "
          f"{logit_err:.2e}", flush=True)
    th_launches, t_heads = phase_swin_adapt_full(
        cfg_t, t_sd, t_stats, SEED, card, attn_route="heads",
        n_videos=SWIN_T_VIDEOS, what="swin-T")
    bh_launches, b_heads = phase_swin_adapt_full(
        _swin_cfg(), sd, stats, SEED, card, attn_route="heads",
        n_videos=SWIN_B_HEADS_VIDEOS, warmup=1)
    for row in unfused_rows:
        by_route, fwd_paths = ((th_launches, th_forward)
                               if "heads" in row["name"]
                               else (t_launches, t_forward))
        row["launches"] = by_route[row["name"]]
        row["launches_forward_paths"] = fwd_paths[row["name"]]
        if "heads" in row["name"]:
            row["launches_swin_b"] = bh_launches[row["name"]]
    lap("phase 17, Swin-T slices and Swin-B under the heads route")
    for s in tanet_modes:
        print(f"TANet, {s['mode']}: median {s['median_ms']:.3f} ms/video (min "
              f"{s['min_ms']:.3f}, max {s['max_ms']:.3f}, {s['videos']} "
              f"videos), {s['chosen']} chosen layers, host "
              f"{fmt(s.get('host_ms'))} ms, device busy "
              f"{fmt(s.get('device_busy_ms'))} ms, idle share "
              f"{fmt(s.get('idle_share'))}, peak memory {s['peak_gib']:.3f} "
              f"GiB; on {card}", flush=True)
    for s in (packed, ln_proj, proj, b_heads, t_packed, t_heads):
        print(f"{s['model']} adapt step, route {s['route']}: median "
              f"{s['median_ms']:.3f} ms/video (min {s['min_ms']:.3f}, max "
              f"{s['max_ms']:.3f}, {s['videos']} videos), host "
              f"{fmt(s.get('host_ms'))} ms, device busy "
              f"{fmt(s.get('device_busy_ms'))} ms, idle share "
              f"{fmt(s.get('idle_share'))}, peak memory {s['peak_gib']:.3f} "
              f"GiB; on {card}", flush=True)
    print(json.dumps({"kernels": tam_rows + bn_rows + swin_rows + proj_rows
                      + unfused_rows}))
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
