"""Seeded weights, synthetic videos and step timing for runs of the port
that need no checkpoint and no dataset: what chip_smoke.py and
tools/attention_routes.py both set up, kept in one place.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def swin_cfg(t=16, hw=224, **model_kw):
    """``swin_ucf101_preset`` at ``t`` frames of ``hw`` x ``hw``, with
    ``model_kw`` replacing fields of its model config."""
    from vitta_tpu_torch.config import swin_ucf101_preset
    cfg = swin_ucf101_preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t, input_size=hw,
                                 scale_size=hw),
        model=dataclasses.replace(cfg.model, **model_kw))


def swin_weights(cfg, seed):
    """A seeded state dict of the model of ``cfg``; the bias tables are
    drawn wide (std 0.5, not the initialiser's 0.02) so that a wrong bias
    would show in the logits."""
    from vitta_tpu_torch.models import get_model
    torch.manual_seed(seed)
    model = get_model(cfg, attn_route="packed")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.5)
    return {k: v.clone() for k, v in model.state_dict().items()}


def videos(rng, n, t, hw, views=2, classes=101):
    """``n`` synthetic uint8 videos as a stream hands them to
    ``tta_stream``: (views (V,T,S,S,3), eval clip (1,T,S,S,3), label)."""
    return [(rng.integers(0, 256, (views, t, hw, hw, 3), dtype=np.uint8),
             rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8),
             np.asarray([i % classes], np.int64)) for i in range(n)]


def normalized_batches(rng, cfg, sizes, t, hw):
    """Synthetic uint8 clips, normalised on the host as a loader hands
    them to the precompute: [(float32 (B,T,S,S,3), labels)]."""
    mean = np.asarray(cfg.data.input_mean, np.float32)
    std = np.asarray(cfg.data.input_std, np.float32)
    out = []
    for b in sizes:
        clip = rng.integers(0, 256, (b, t, hw, hw, 3), dtype=np.uint8)
        out.append(((clip.astype(np.float32) - mean) / std,
                    np.zeros(b, np.int64)))
    return out


class StepTimes:
    """A metrics writer that collects the per-video times ``tta_stream``
    reports."""

    def __init__(self):
        self.ms = []

    def scalar(self, tag, value, step):
        if tag == "tta/step_ms":
            self.ms.append(value)


def device_breakdown(fn, top: int = 8):
    """(host ms, device-busy ms, [(kernel name, ms, launches)]) of one
    call of ``fn`` that ends synchronised, from torch.profiler, after one
    call to warm up; the busy time is the sum of all kernels' durations
    (one stream, so they do not overlap), the list its ``top`` largest by
    name.  The busy time is 0 when the profiler records no kernel."""
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
