"""Mid-stream TTA state checkpointing of the port (adapt/stream_ckpt.py),
held as tests/test_stream_ckpt.py holds vitta_tpu's: a stream killed after
a checkpoint and resumed from disk reproduces the uninterrupted trajectory
exactly (the same final parameters, BatchNorm buffers, momentum, EMA,
meters and accuracy row, bit for bit); a manifest mismatch raises; clear
and a missing checkpoint behave as there; the commit marker has vitta_tpu's
layout.  Then the sweep driver: ``run_corruption_sweep`` over two
corruptions with ``--stream_ckpt_every 2``, killed by an exception after
video 3 of the second corruption and run again with ``--resume``, ends
where the uninterrupted sweep ends.

The engine is the full-width TANet of tests/torch_engine_modes.py at T = 2,
32 x 32, with the preset's dropout 0.8 on, so that each video's dropout
seed is part of the trajectory; the sweep runs the CLI's own seeded weights
and synthetic videos at SKILL.md's tiny flags.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests import torch_engine_modes as tm
from vitta_tpu_torch.adapt.engine import TTAState, VittaEngine
from vitta_tpu_torch.adapt.loops import tta_stream
from vitta_tpu_torch.adapt.stream_ckpt import StreamCheckpointer
from vitta_tpu_torch.cli import drivers, main_eval
from vitta_tpu_torch.cli.opts import get_opts
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.data.records import VideoRecord
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.ops.stats import TapStats
from vitta_tpu_torch.tools.tanet_breakdown import tanet_source

torch.set_num_threads(1)

T, HW, K, V = 2, 32, 5, 2
N_VIDEOS = 6
KILL_AT = 4      # videos completed before the simulated kill
EVERY = 2        # checkpoint cadence


@pytest.fixture(scope="module")
def engine():
    sd, _variables = tm.tanet_weights(T)
    cfg = tm.cfg_of(tanet_ucf101_preset, T)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.8))
    model = get_model(cfg)
    model.load_state_dict(sd)
    clean = torch.from_numpy(np.random.default_rng(100).normal(
        size=(V, T, HW, HW, 3)).astype(np.float32))
    src = tanet_source(model, clean)
    return VittaEngine(get_model(cfg), cfg, sd, src, device="cpu")


class _Stream:
    """Deterministic per-index synthetic paired stream."""

    def __init__(self, n, start=0):
        self.n, self.start = n, start

    def __len__(self):
        return self.n - self.start

    def __iter__(self):
        for i in range(self.start, self.n):
            rng = np.random.default_rng(1000 + i)
            yield (rng.integers(0, 256, (V, T, HW, HW, 3), dtype=np.uint8),
                   rng.integers(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
                   np.asarray([i % K], np.int64))


class _NoClear:
    """A checkpointer whose completion-clear is suppressed: the simulated
    kill comes before the stream completes, but tta_stream runs to the end
    of its truncated iterator and would clear."""

    def __init__(self, inner):
        self._inner = inner
        self.every = inner.every

    def save(self, *a, **k):
        return self._inner.save(*a, **k)

    def clear(self):
        pass


def _snapshot(state):
    """Copies of everything the stream carries."""
    return {
        "params": {k: p.detach().clone() for k, p in state.params.items()},
        "buffers": {k: b.clone() for k, b in state.batch_stats.items()},
        "momentum": [state.optimizer.state[p]["momentum_buffer"].clone()
                     for g in state.optimizer.param_groups
                     for p in g["params"] if p in state.optimizer.state],
        "ema": {k: tuple(t.clone() for t in v) for k, v in state.ema.items()},
        "step": state.step,
    }


def _assert_same(got, want):
    assert got["step"] == want["step"]
    for part in ("params", "buffers", "ema"):
        assert got[part].keys() == want[part].keys()
        for k, w in want[part].items():
            g = got[part][k]
            for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (g, w))):
                assert torch.equal(a, b), f"{part} {k}"
    assert len(got["momentum"]) == len(want["momentum"]) > 100
    assert all(torch.equal(g, w)
               for g, w in zip(got["momentum"], want["momentum"]))


def test_kill_resume_reproduces_trajectory(engine, tmp_path):
    want_row, want_state, want_meters = tta_stream(engine, _Stream(N_VIDEOS),
                                                   seed=3)
    want = _snapshot(want_state)

    # the interrupted run: KILL_AT videos with checkpointing, then
    # everything in memory dropped (the "kill") and the stream resumed
    # from disk through a fresh checkpointer
    ckpt_run = StreamCheckpointer(str(tmp_path / "ck"), every=EVERY)
    tta_stream(engine, _Stream(KILL_AT), seed=3,
               checkpointer=_NoClear(ckpt_run))
    ckpt = StreamCheckpointer(str(tmp_path / "ck"), every=EVERY)
    got = ckpt.restore(engine.init_state(), generator=engine.generator)
    assert got is not None
    state0, start, meters = got
    assert start == KILL_AT and state0.step == KILL_AT
    row, state, got_meters = tta_stream(
        engine, _Stream(N_VIDEOS, start=start), seed=3, state=state0,
        checkpointer=ckpt, start_index=start, meter_state=meters)
    assert row == want_row
    _assert_same(_snapshot(state), want)
    for name in ("top1", "top5", "loss_reg", "loss_consis", "loss_ce"):
        assert (got_meters[name].sum, got_meters[name].count) == \
            (want_meters[name].sum, want_meters[name].count), name
    # the completed stream clears its checkpoint
    assert ckpt.restore(engine.init_state()) is None


def _tiny_state(value):
    """A TTAState of a small module, its optimizer one step on."""
    torch.manual_seed(int(value))
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    ema = {"a": TapStats(torch.full((2,), value), torch.full((2,), -value))}
    return TTAState(dict(lin.named_parameters()), opt, ema, int(value), {})


def test_checkpointer_clear_and_missing(tmp_path):
    ckpt = StreamCheckpointer(str(tmp_path / "c2"), every=1)
    assert ckpt.restore(_tiny_state(0.0)) is None
    saved = _tiny_state(5.0)
    generator = torch.Generator().manual_seed(11)
    ckpt.save(saved, 5, {"top1": (200.0, 4), "top5": (400.0, 4)},
              generator=generator)
    want_draw = torch.rand(3, generator=generator)
    template = _tiny_state(1.0)
    restored_gen = torch.Generator().manual_seed(0)
    got = ckpt.restore(template, generator=restored_gen)
    assert got is not None
    state, nxt, meters = got
    assert nxt == 5 and meters["top1"] == (200.0, 4) and state.step == 5
    for k, p in saved.params.items():
        assert torch.equal(state.params[k], p) and state.params[k] is \
            template.params[k]
    assert torch.equal(state.ema["a"].mean, saved.ema["a"].mean)
    assert type(state.ema["a"]) is TapStats
    for p, q in zip(template.params.values(), saved.params.values()):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           saved.optimizer.state[q]["momentum_buffer"])
    assert torch.equal(torch.rand(3, generator=restored_gen), want_draw)
    # one committed state file: the superseded ones are removed
    ckpt.save(saved, 6, {"top1": (200.0, 4)})
    assert sorted(p.name for p in (tmp_path / "c2").iterdir()) == \
        ["latest.json", "step_6.pt"]
    ckpt.clear()
    assert ckpt.restore(_tiny_state(0.0)) is None


def test_commit_marker_layout_matches_vitta_tpu(tmp_path):
    """latest.json: vitta_tpu's keys and meters ({name: [sum, count]})."""
    from vitta_tpu.adapt.stream_ckpt import StreamCheckpointer as JaxCkpt
    meters = {"top1": (200.0, 4), "loss_reg": (1.5, 4)}
    JaxCkpt(str(tmp_path / "j"), every=1).save(
        {"x": np.arange(3, dtype=np.float32)}, 7, meters)
    StreamCheckpointer(str(tmp_path / "p"), every=1).save(
        _tiny_state(2.0), 7, meters)
    want, got = (json.loads((tmp_path / d / "latest.json").read_text())
                 for d in ("j", "p"))
    assert got.keys() == want.keys()
    assert got["next_bi"] == want["next_bi"] and got["meters"] == want["meters"]


def test_manifest_mismatch_errors_loudly(tmp_path):
    d = str(tmp_path / "mf")
    StreamCheckpointer(d, every=1, manifest={"corruptions": ["gauss", "rain"]})
    # the same manifest reopens
    StreamCheckpointer(d, every=1, manifest={"corruptions": ["gauss", "rain"]})
    with pytest.raises(RuntimeError, match="different stream group"):
        StreamCheckpointer(d, every=1, manifest={"corruptions": ["gauss"]})
    # an open without a manifest is unaffected
    StreamCheckpointer(d, every=1)


_MAKE_DATASETS, _EVALUATE = main_eval.make_datasets, drivers.evaluate
SWEEP_VIDEOS = 5
KILL_VIDEO = 3   # the second corruption's item that raises


class _Dying:
    """The paired dataset of one corruption, raising at item ``die_at``."""

    def __init__(self, paired, die_at):
        self._paired, self._die_at = paired, die_at

    def __len__(self):
        return len(self._paired)

    def __getitem__(self, i):
        if i == self._die_at:
            raise RuntimeError("simulated preemption")
        return self._paired[i]

    def __getattr__(self, name):
        return getattr(self._paired, name)


def _sweep(tmp_path, monkeypatch, extra=(), die=False):
    """run_corruption_sweep over two corruptions; (results, final state of
    each corruption, last logged losses per corruption and video)."""
    argv = ["--clip_length", "2", "--input_size", "32", "--scale_size", "40",
            "--result_dir", str(tmp_path), "--video_source", "synthetic",
            "--stat_reg", "BNS", "--stream_ckpt_every", "2", "--workers", "2",
            *extra]
    _args, cfg = get_opts(argv)
    records = [VideoRecord(f"v{i}", 40 + 3 * i, i % 7)
               for i in range(SWEEP_VIDEOS)]
    states = {}
    make, evaluate = _MAKE_DATASETS, _EVALUATE

    def making(cfg_, *a, **k):
        paired = make(cfg_, *a, **k)
        return _Dying(paired, KILL_VIDEO) if die and states.get("_n") else \
            paired

    def recording(cfg_, corruption, **k):
        rows, state = evaluate(cfg_, corruption, **k)
        states[corruption] = _snapshot(state)
        states["_n"] = 1
        return rows, state

    monkeypatch.setattr(main_eval, "make_datasets", making)
    monkeypatch.setattr(drivers, "evaluate", recording)
    results = drivers.run_corruption_sweep(
        cfg, ["gauss", "contrast"], source_kind="synthetic", records=records,
        device="cpu")
    losses = {}
    for c in ("gauss", "contrast"):
        for line in (tmp_path / f"metrics_{c}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            losses[(c, rec["tag"], rec["step"])] = rec["value"]
    return results, states, {k: v for k, v in losses.items()
                             if k[1] != "tta/step_ms"}


def test_sweep_kill_and_resume_matches_uninterrupted(tmp_path, monkeypatch):
    want, want_states, want_losses = _sweep(tmp_path / "full", monkeypatch)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _sweep(tmp_path / "cut", monkeypatch, die=True)
    state = json.loads((tmp_path / "cut" / "sweep_state.json").read_text())
    assert list(state) == ["gauss"]
    latest = json.loads((tmp_path / "cut" / "stream_ckpt_contrast"
                         / "latest.json").read_text())
    assert latest["next_bi"] == 2
    got, got_states, got_losses = _sweep(tmp_path / "cut", monkeypatch,
                                         extra=["--resume"])
    assert got == want
    # gauss was replayed from sweep_state.json; contrast resumed mid-stream
    assert "gauss" not in got_states
    _assert_same(got_states["contrast"], want_states["contrast"])
    assert got_losses == want_losses


def test_metrics_timer_and_profile_on_the_cpu(tmp_path):
    """utils/observability.py: the JSONL scalar stream that evaluate
    writes, StepTimer (no card here: nothing to wait for) and profile's
    Chrome trace."""
    from vitta_tpu_torch.utils.observability import (MetricsWriter,
                                                     StepTimer, profile)
    mw = MetricsWriter(str(tmp_path), name="m")
    mw.scalar("tta/loss_reg", 1.5, 0)
    mw.scalar("tta/top1_avg", 50.0, 1)
    mw.close()
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
             .splitlines()]
    assert [(d["tag"], d["value"], d["step"]) for d in lines] == \
        [("tta/loss_reg", 1.5, 0), ("tta/top1_avg", 50.0, 1)]
    timer = StepTimer()
    with profile(str(tmp_path / "trace")):
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.elapsed_ms(sync_on=y) >= 0.0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with profile("", enabled=True):
        pass
