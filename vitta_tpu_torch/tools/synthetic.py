"""Seeded weights, synthetic videos and step timing for runs of the port
that need no checkpoint and no dataset: what chip_smoke.py and
tools/attention_routes.py both set up, kept in one place; the model zoo's
configurations, models and seeded weights at full width (``ZOO_MODELS``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


# Video Swin models by name, as fields of the model config that differ from
# ``swin_ucf101_preset`` (Swin-B).  Swin-T: SwinTransformer/
# Video-Swin-Transformer, configs/recognition/swin/
# swin_tiny_patch244_window877_kinetics400_1k.py
SWIN_MODELS = {
    "swin_b": {},
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2),
                   num_heads=(3, 6, 12, 24)),
}


# The model zoo beside TANet and Video Swin (vitta_tpu/models/__init__.py:
# 24-35), by name: (the configuration's arch, the ``--chosen_blocks`` a user
# passes for it; the TANet preset's own match no VideoMAE or Inception
# layer, vitta_tpu/adapt/engine.py:100-113).  "tanet_no_tam" is
# ``TANet(use_tam=False)``, which no flag builds.
ZOO_MODELS = {
    "videomae": ("videomae", ("norm",)),
    "r2plus1d": ("r2plus1d", ("layer3", "layer4")),
    "i3d_resnet18": ("i3d_resnet18", ("layer3", "layer4")),
    "i3d_resnet50": ("i3d_resnet50", ("layer3", "layer4")),
    "i3d_incep": ("i3d_incep", ("Mixed_4", "Mixed_5")),
    "tanet_no_tam": ("tanet", ("layer3", "layer4")),
}


def zoo_cfg(name, t=16, hw=224, num_classes=101):
    """``tanet_ucf101_preset`` for the zoo model ``name`` (the preset the
    CLI builds every arch but Video Swin on), at ``t`` frames of ``hw`` x
    ``hw`` and ``num_classes``, with its chosen blocks."""
    from vitta_tpu_torch.config import tanet_ucf101_preset
    arch, chosen = ZOO_MODELS[name]
    cfg = tanet_ucf101_preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t, input_size=hw,
                                 scale_size=hw),
        model=dataclasses.replace(cfg.model, arch=arch,
                                  num_classes=num_classes),
        tta=dataclasses.replace(cfg.tta, chosen_blocks=chosen))


def zoo_model(name, cfg, deterministic=False):
    """The zoo model ``name`` of ``cfg`` at full width: ``get_model(cfg)``,
    or TANet without its TAMs.  ``deterministic`` sets its dropout and
    drop path to 0 (where the card's and the CPU's generators would draw
    other masks)."""
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.models.tanet import TANet
    model = (TANet(cfg.model.num_classes, clip_length=cfg.data.clip_length,
                   dropout=cfg.model.dropout, use_tam=False)
             if name == "tanet_no_tam" else get_model(cfg))
    if deterministic:
        model.dropout = 0.0              # the heads' (R(2+1)D has none)
        for blk in getattr(model, "blocks", ()):
            blk.drop_path = 0.0          # VideoMAE's
    return model


def zoo_weights(name, cfg, seed):
    """A seeded state dict of the zoo model ``name``: torch's initialisers
    under ``torch.manual_seed(seed)``, then every BatchNorm's running mean
    drawn from N(0, 0.1) and running variance from U(0.5, 1.5), so that no
    BatchNorm is the identity."""
    from vitta_tpu_torch.models.layers import BatchNorm
    torch.manual_seed(seed)
    model = zoo_model(name, cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return {k: v.clone() for k, v in model.state_dict().items()}


def swin_cfg(t=16, hw=224, **model_kw):
    """``swin_ucf101_preset`` at ``t`` frames of ``hw`` x ``hw``, with
    ``model_kw`` replacing fields of its model config."""
    from vitta_tpu_torch.config import swin_ucf101_preset
    cfg = swin_ucf101_preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=t, input_size=hw,
                                 scale_size=hw),
        model=dataclasses.replace(cfg.model, **model_kw))


def swin_model(cfg, dtype="float32", attn_route="packed", **kw):
    """The Video Swin of ``cfg`` at the compute ``dtype``, built directly as
    vitta_tpu's benchmark builds its bfloat16 Swin-B
    (``Recognizer3D(..., dtype=...)``, bench.py:117): ``get_model`` builds
    Video Swin at float32 only.  ``kw`` overrides Recognizer3D's other
    arguments (the dropout rates)."""
    from vitta_tpu_torch.models.swin import Recognizer3D
    mc = cfg.model
    args = dict(patch_size=mc.patch_size, window_size=mc.window_size,
                embed_dim=mc.embed_dim, depths=mc.depths,
                num_heads=mc.num_heads, drop_path_rate=mc.drop_path_rate,
                stat_types=cfg.tta.tap_stat_types(), attn_route=attn_route,
                dtype=dtype)
    args.update(kw)
    return Recognizer3D(mc.num_classes, **args)


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


def device_breakdown(fn, top: int | None = 8):
    """(host ms, device-busy ms, [(kernel name, ms, launches)]) of one
    call of ``fn`` that ends synchronised, from torch.profiler, after one
    call to warm up; the busy time is the sum of all kernels' durations
    (one stream, so they do not overlap), the list its ``top`` largest by
    name (all of them where ``top`` is None).  The busy time is 0 when the
    profiler records no kernel."""
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
