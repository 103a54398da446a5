"""Time Video Swin-B's adapt step under its three attention routes in one
process, on the card.

    python3 -m vitta_tpu_torch.tools.attention_routes [videos per stream]

Builds Swin-B (``swin_ucf101_preset``, float32, drop-path 0.2 and head
dropout 0.5 on) once per route from one seeded state dict and one set of
source statistics, then runs ``tta_stream`` over the same seeded synthetic
uint8 videos (2 views and 1 eval clip of 16x224x224 each) in the order
packed, proj, ln_proj, ln_proj, proj, packed, so that a drift of the host
over the call falls on every route alike.  Prints, per stream, the median,
least and largest ms/video after two warm-up videos (host clock,
synchronised on each video's metrics, host-to-device copy included) and
the peak memory, then per route both streams' videos together and one
profiled step with its inputs on the card (host ms, device-busy ms, idle
share).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.adapt.loops import tta_stream
from vitta_tpu_torch.adapt.precompute import compute_source_statistics
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.tools.synthetic import (StepTimes, device_breakdown,
                                             normalized_batches, swin_cfg,
                                             swin_weights)
from vitta_tpu_torch.tools.synthetic import videos as synthetic_videos

ORDER = ("packed", "proj", "ln_proj", "ln_proj", "proj", "packed")
WARMUP = 2
SEED = 0


def profiled_step(engine, state, video):
    """(host ms, device-busy ms) of one adapt+eval step with its inputs on
    the card; (host ms, None) when the profiler records no kernel."""
    views, clip, label = (torch.from_numpy(a).cuda() for a in video)
    box = [state]

    def step():
        box[0], _m = engine.adapt_eval_step(box[0], views, clip, label)

    host_ms, busy, _rows = device_breakdown(step)
    return host_ms, busy if busy > 0 else None


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("attention_routes: no CUDA device", file=sys.stderr)
        return 1
    n_videos = int(argv[1]) if len(argv) > 1 else 10
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}", flush=True)

    cfg = swin_cfg()
    t, hw = cfg.data.clip_length, cfg.data.input_size
    sd = swin_weights(cfg, SEED)
    model = get_model(cfg, attn_route="packed")
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(SEED)
    stats = compute_source_statistics(
        model, normalized_batches(rng, cfg, (2,), t, hw))
    del model
    videos = synthetic_videos(rng, n_videos, t, hw,
                              classes=cfg.model.num_classes)

    by_route = {}
    for route in ORDER:
        engine = VittaEngine(get_model(cfg, attn_route=route), cfg, sd, stats)
        writer = StepTimes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _top1, state, meters = tta_stream(engine, videos, seed=SEED,
                                          metrics_writer=writer)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        warm = writer.ms[WARMUP:]
        host_ms, busy = profiled_step(engine, state, videos[-1])
        by_route.setdefault(route, []).append((warm, host_ms, busy, peak))
        print(f"{route}: median {statistics.median(warm):.3f} ms/video (min "
              f"{min(warm):.3f}, max {max(warm):.3f}, {len(warm)} videos "
              f"after {WARMUP} warm-up), peak memory {peak:.3f} GiB, loss_reg "
              f"{meters['loss_reg'].avg:.5f}; profiled step: host "
              f"{host_ms:.3f} ms, device busy "
              + ("not measured" if busy is None else
                 f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / host_ms):.2f}"),
              flush=True)
        del engine, state
    for route, runs in by_route.items():
        ms = [v for warm, *_ in runs for v in warm]
        busy = [b for _w, _h, b, _p in runs if b is not None]
        print(f"route {route}, both streams: median "
              f"{statistics.median(ms):.3f} ms/video (min {min(ms):.3f}, max "
              f"{max(ms):.3f}, {len(ms)} videos), device busy "
              + ("not measured" if not busy else
                 f"{statistics.mean(busy):.3f} ms")
              + f", host of the profiled steps "
              f"{', '.join(f'{h:.3f}' for _w, h, _b, _p in runs)} ms, peak "
              f"memory {max(p for *_x, p in runs):.3f} GiB; on {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
