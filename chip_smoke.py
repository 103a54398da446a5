"""Smoke run of vitta_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from this checkout, checks each against its plain PyTorch version, and
drives the TANet float32 ViTTA stream end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: needs CUDA; prints the card's name and power limit.
2. build: every ``vitta_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
3. kernels against plain: the TAM dynamic conv forward and backward at
   every TAM shape of ResNet-50 (n=2 adapt, n=1 eval, t=16, and t=3 for
   the zero-padded ends), values and CUDA-event times.
4. slice at small size: full-width TANet at T=2, 32x32, two tta_online
   steps on the card and on the CPU from one seeded state dict.
5. slice at full size: TANet for 101 classes, 2 views x 16 frames x
   224x224, the reference operating point (tanet_ucf101_preset), through
   ``tta_stream`` over seeded synthetic uint8 videos; the TAM launch
   counters must show 16 forward launches per forward pass and 16
   backward launches per step.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that one JSON line of the
kernels.  TF32 is switched off for matmuls and convolutions, because the
comparisons are float32 ones.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
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
N_VIDEOS = 10     # full-slice videos; the first two are warm-up
SEED = 0


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


def check_close(name, got, want, rtol, atol=None):
    """Max abs error of ``got``; raises unless |got-want| <= atol +
    rtol*|want| everywhere (atol defaults to rtol)."""
    atol = rtol if atol is None else atol
    err = (got - want).detach().abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max()):.3e} "
                             f"exceeds rtol={rtol} atol={atol}")
    return float(err.max())


# ---------------------------------------------------------------------------
def phase_kernels(dev):
    """Kernel against plain on the card; returns the kernels' JSON rows."""
    from vitta_tpu_torch.ops.cuda_tam import (tam_bwd_cuda, tam_fwd_cuda,
                                              tam_dynamic_conv,
                                              tam_dynamic_conv_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0}
    per_step = dict.fromkeys(("fwd", "bwd", "plain_fwd", "plain_bwd"), 0.0)
    dev_step = dict.fromkeys(per_step, 0.0)
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
            fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
            print(f"tam n={n} t={t} {h}x{w}x{c}: err fwd {e_f:.2e} bwd "
                  f"{e_b:.2e} | event ms: fwd {ev['fwd']:.4f} plain "
                  f"{ev['plain_fwd']:.4f}, bwd {ev['bwd']:.4f} plain "
                  f"{ev['plain_bwd']:.4f} | device ms: fwd {fmt(dv['fwd'])} "
                  f"plain {fmt(dv['plain_fwd'])}, bwd {fmt(dv['bwd'])} plain "
                  f"{fmt(dv['plain_bwd'])}", flush=True)
            if (n, t) == (2, 16):
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
    return [
        {"name": "tam_fwd", "route": "cuda",
         "source": "vitta_tpu_torch/csrc/tam.cu",
         "replaces": "vitta_tpu/ops/pallas_tam.py:77",
         "max_abs_err": err["fwd"], "ms": per_step["fwd"],
         "plain_ms": per_step["plain_fwd"]},
        {"name": "tam_bwd", "route": "cuda",
         "source": "vitta_tpu_torch/csrc/tam.cu",
         "replaces": "vitta_tpu/ops/pallas_tam.py:92",
         "max_abs_err": err["bwd"], "ms": per_step["bwd"],
         "plain_ms": per_step["plain_bwd"]},
    ]


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

    kernels = phase_kernels(torch.device("cuda"))
    phase_small_slice(SEED)
    launches = phase_full_slice(SEED, N_VIDEOS, card)
    for row in kernels:
        row["launches"] = launches[row["name"].split("_")[1]]
    print(json.dumps({"kernels": kernels}))
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
