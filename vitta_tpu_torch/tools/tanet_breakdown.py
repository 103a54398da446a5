"""Where a TANet adaptation step's device time goes, by class of kernel.

    python3 -m vitta_tpu_torch.tools.tanet_breakdown [n_videos] [stat_reg] \
        [compute_dtype]

Runs ``tta_stream`` of TANet at the reference operating point
(``tanet_ucf101_preset``: 101 classes, 2 views x 16 frames x 224 x 224,
seeded random weights, synthetic uint8 videos) at ``compute_dtype``
(default ``float32``; ``bfloat16``: the bfloat16 TANet, float32 masters)
over ``n_videos`` (default 6, the first two warm-up) under ``stat_reg``
(default ``mean_var``), then profiles one adapt+eval step with its inputs
on the card (``tools/synthetic.py:device_breakdown``) and prints the step's
host time, device-busy time and idle share, the busy time split into
classes of kernels by name (convolutions and matrix products, cuDNN's
layout transposes, elementwise passes (casts among them), reductions, the
hand-written kernels, the optimizer, the rest), and the largest kernels.
Needs a CUDA device; the numbers are that card's.

chip_smoke.py shares the set-up and the classes.  To compare two checkouts
on one card, run the module from each in one command, in turns.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from vitta_tpu_torch.tools.synthetic import StepTimes, device_breakdown, videos

# class -> substrings of kernel names, matched in this order
KERNEL_CLASSES = (
    ("bn_stats", ("bn_stats_",)),
    ("tam", ("tam_",)),
    ("reduce_partials", ("reduce_partials", "col_sums")),
    ("optimizer", ("multi_tensor", "foreach", "fused_sgd", "fused_adam")),
    ("reduction", ("reduce_kernel", "Reduce", "mean_kernel", "sum_kernel")),
    ("transpose", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution_or_product", ("cudnn", "conv", "gemm", "xmma", "cutlass",
                                "implicit", "wgrad", "dgrad", "sm90_",
                                "sm80_", "ampere", "hopper", "gemv")),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "Elementwise", "CatArray", "copy",
                     "fill", "where")),
)


def kernel_classes(rows) -> dict:
    """{class: [ms, launches]} of ``device_breakdown``'s rows (all of them:
    ask it for ``top=10**6``), by the first class whose substring the
    kernel's name holds; ``other`` takes the rest."""
    out = {name: [0.0, 0] for name, _ in KERNEL_CLASSES}
    out["other"] = [0.0, 0]
    for key, ms, count in rows:
        cls = next((name for name, subs in KERNEL_CLASSES
                    if any(s in key for s in subs)), "other")
        out[cls][0] += ms
        out[cls][1] += count
    return out


def tanet_cfg(clip_length, num_classes, tta=None, optim=None, **model_kw):
    """``tanet_ucf101_preset`` at ``clip_length`` frames and
    ``num_classes``, with fields of its model, tta and optim configs
    replaced."""
    from vitta_tpu_torch.config import tanet_ucf101_preset
    cfg = tanet_ucf101_preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=clip_length),
        model=dataclasses.replace(cfg.model, num_classes=num_classes,
                                  **model_kw),
        optim=dataclasses.replace(cfg.optim, **(optim or {})),
        tta=dataclasses.replace(cfg.tta, **(tta or {})))


def tanet_source(model, clip, stat_reg="mean_var"):
    """The source side of ``stat_reg`` from one clean ``clip`` (B, T, S, S,
    3) float32 on the model's device: the BatchNorm2d layers' output
    statistics (mean_var), relation-map vectors (cossim), or nothing
    (BNS: the model's running statistics are the source)."""
    if stat_reg == "BNS":
        return None
    if stat_reg == "cossim":
        from vitta_tpu_torch.adapt.precompute import compute_cossim_statistics
        return compute_cossim_statistics(
            model, [(clip, None)], clip_len=clip.shape[1], device=clip.device)
    from vitta_tpu_torch.models.layers import Taps, flatten_taps
    taps = Taps({"stat"})
    with torch.no_grad():
        model(clip, taps)
    return {k: (s.mean.cpu().numpy(), s.var.cpu().numpy())
            for k, s in flatten_taps(taps).items()
            if "g_bn" not in k and "l_bn" not in k}


def tanet_engine(cfg, seed, hw=224, device="cuda"):
    """(engine, rng): the model of ``cfg`` with weights from ``seed``, its
    source made from one seeded clean clip of 2 x T x hw x hw on
    ``device``; ``rng`` goes on to make the videos."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.models import get_model
    dev = torch.device(device)
    torch.manual_seed(seed)
    model = get_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    clean = torch.from_numpy(rng.normal(
        size=(2, cfg.data.clip_length, hw, hw, 3)).astype(np.float32)).to(dev)
    src = tanet_source(model.to(dev), clean, cfg.tta.stat_reg)
    del clean, model
    return VittaEngine(get_model(cfg), cfg, sd, src, device=dev), rng


def profile_step(engine, video, state=None):
    """(host ms, device-busy ms, classes, largest kernels) of one
    adapt+eval step on ``video`` with its arrays on the card."""
    views, clip, label = (torch.from_numpy(a).to(engine.device)
                          for a in video)
    box = [engine.init_state() if state is None else state]

    def step():
        box[0], _m = engine.adapt_eval_step(box[0], views, clip, label)

    host_ms, busy, rows = device_breakdown(step, top=10 ** 6)
    return host_ms, busy, kernel_classes(rows), rows[:10]


def main(argv) -> int:
    n_videos = int(argv[1]) if len(argv) > 1 else 6
    stat_reg = argv[2] if len(argv) > 2 else "mean_var"
    dtype = argv[3] if len(argv) > 3 else "float32"
    if not torch.cuda.is_available():
        print("tanet_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from vitta_tpu_torch.adapt.loops import tta_stream
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    tta = dict(stat_reg=stat_reg)
    if stat_reg == "cossim":
        tta["stat_type"] = ("temp",)
    engine, rng = tanet_engine(tanet_cfg(16, 101, tta=tta,
                                         compute_dtype=dtype), seed=0)
    data = videos(rng, n_videos, 16, 224)
    writer = StepTimes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _top1, state, meters = tta_stream(engine, data, seed=0,
                                      metrics_writer=writer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms, busy, classes, largest = profile_step(engine, data[-1], state)
    warm = writer.ms[2:] or writer.ms
    print(json.dumps({
        "card": card, "stat_reg": stat_reg, "compute_dtype": dtype,
        "videos": len(warm),
        "median_ms_per_video": statistics.median(warm),
        "min_ms": min(warm), "max_ms": max(warm), "peak_gib": peak,
        "loss_reg": meters["loss_reg"].avg, "host_ms": host_ms,
        "device_busy_ms": busy,
        "idle_share": max(0.0, 1 - busy / host_ms) if busy else None,
        "classes_ms_launches": classes,
        "largest": [(k[:70], round(ms, 3), n) for k, ms, n in largest]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
