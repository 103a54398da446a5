"""Stream parallelism of the port (vitta_tpu_torch/parallel/, the
multi-process half of adapt/stream_ckpt.py and cli/drivers.py:
run_parallel_sweep, entry.py) under real 2-process gloo groups on the CPU
(tests/_torch_mp_worker.py spawned by ``parallel.mesh.SpawnedGroup``, one
thread a process, a ``file://`` store, every wait bounded).

* ``run_parallel_streams`` over 4 streams x 2 videos in groups of 2, tiny
  TANet (T 2, 24 x 24, 4 classes, dropout 0): each stream's per-video
  losses, top-1, final parameters and EMA are **bit-equal** to the port's
  single-stream engine fed the same videos and seeds, and agree with
  vitta_tpu's ``VittaEngine`` run stream by stream at
  tests/torch_engine_modes.py's tolerances (losses rtol 1e-3 / atol 1e-5,
  each update within 2% of its norm, top-1 exactly), which is what
  vitta_tpu's ``run_parallel_streams`` computes per stream
  (tests/test_parallel.py).  In one process (world 1) the same.
* ``run_parallel_sweep`` over 3 corruptions at world 2 (the second group
  of one stream: rank 1 idles in it, joining every gather and barrier),
  ``--stream_ckpt_every 1``: killed after its first mid-stream checkpoint
  (each rank's own state file under ``step_1/``, rank 0's commit marker
  with per-stream meter vectors) and resumed, it gives the uninterrupted
  run's rows and the same per-video losses from the resume point on, on
  both ranks (as tests/test_multiprocess_sweep.py holds vitta_tpu's).
* ``sharded_validate`` over 2 ranks (batch 2, a remainder batch of 1):
  top-1 and top-5 equal to vitta_tpu's ``sharded_validate`` on a
  one-device mesh and to the port's source baseline.
* ``stream_device``'s mapping and its raises; ``entry.entry`` and
  ``entry.dryrun_multichip(2)``.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_mp_worker as W
from tests import torch_engine_modes as tm
from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.config import tanet_ucf101_preset as jax_preset
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.parallel import mesh
from vitta_tpu_torch.parallel.streams import (StreamParallelEngine,
                                              run_parallel_streams,
                                              stream_video_seed)
from vitta_tpu_torch.tools.tanet_breakdown import tanet_source

torch.set_num_threads(1)

WAIT_S = 280       # each launch; the workers' collectives time out first
RTOL, ATOL = tm.RTOL, tm.ATOL


def _launch(tmp: Path, name: str, *args: str) -> mesh.SpawnedGroup:
    """2 spawned worker processes of ``_torch_mp_worker`` in a group of
    their own (a ``file://`` store under ``tmp``)."""
    return mesh.SpawnedGroup(W.worker, 2, (str(tmp / f"store_{name}"),
                                           *args))


@pytest.fixture(scope="module")
def weights():
    """(port state dict, JAX variables, source statistics) of the tiny
    TANet, running statistics away from their defaults."""
    torch.manual_seed(0)
    oracle = TorchTSN(W.K, W.T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    cfg = W.streams_cfg()
    model = get_model(cfg)
    model.load_state_dict(sd)
    clean = torch.from_numpy(np.random.default_rng(7).normal(
        size=(W.V, W.T, W.HW, W.HW, 3)).astype(np.float32))
    return sd, convert_tanet_checkpoint(sd, W.K), tanet_source(model, clean)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The workers' outputs: the streams run, and the sweep run plain,
    killed (its checkpoint directory as the kill left it) and resumed."""
    tmp = tmp_path_factory.mktemp("mp")
    sd, _variables, src = weights
    setup = tmp / "setup.pt"
    torch.save({"sd": sd, "src": src}, setup)
    plain, cut = tmp / "plain", tmp / "cut"
    launches = [
        _launch(tmp, "streams", "streams", str(setup), str(tmp / "streams")),
        _launch(tmp, "plain", "sweep", str(plain), str(tmp / "sweep"),
                "plain")]
    killed = _launch(tmp, "kill", "sweep", str(cut), str(tmp / "sweep"),
                     "kill")
    for group in launches:
        group.join(WAIT_S)
    killed.join(WAIT_S, expect=3)
    (ckpt_dir,) = cut.glob("stream_ckpt_group_*")
    after_kill = {
        "files": sorted(str(p.relative_to(ckpt_dir))
                        for p in ckpt_dir.rglob("*")),
        "latest": json.loads((ckpt_dir / "latest.json").read_text()),
        "manifest": json.loads((ckpt_dir / "manifest.json").read_text())}
    _launch(tmp, "resume", "sweep", str(cut), str(tmp / "sweep"),
            "resume").join(WAIT_S)
    out = {"streams": [torch.load(tmp / f"streams.{r}.pt", weights_only=False)
                       for r in range(2)],
           "after_kill": after_kill, "plain_dir": plain, "cut_dir": cut}
    for phase in ("plain", "resume"):
        out[phase] = [json.loads((tmp / f"sweep.{phase}.{r}.json")
                                 .read_text()) for r in range(2)]
    return out


def _port_engine(weights):
    sd, _variables, src = weights
    cfg = W.streams_cfg()
    return VittaEngine(get_model(cfg), cfg, sd, src, device="cpu")


def _where(i):
    """(group, rank) of stream ``i`` at world 2."""
    return i // 2, i % 2


def test_streams_bit_equal_to_the_single_stream_engine(weights, runs):
    eng = _port_engine(weights)
    for i in range(W.S):
        g, r = _where(i)
        worker = runs["streams"][r]
        data = W.ArrayStreamDataset(i)
        state = eng.init_state()
        top1 = []
        for bi in range(W.N_VIDEOS):
            eng.generator.manual_seed(stream_video_seed(0, r, W.N_VIDEOS, bi))
            state, m = eng.adapt_eval_step(state, *data[bi])
            got = worker["steps"][g * W.N_VIDEOS + bi]
            for f in W.LOSSES:
                assert got[f] == float(getattr(m, f)), (i, bi, f)
            assert got["top1"] == float(m.top1)
            top1.append(float(m.top1))
        # every rank holds the group's rows, in stream order
        for other in runs["streams"]:
            assert other["rows"][g][r] == np.mean(top1)
        final = worker["finals"][g]
        for k, p in state.params.items():
            assert torch.equal(final["params"][k], p), (i, k)
        for k, v in state.ema.items():
            assert all(torch.equal(a, b) for a, b in zip(final["ema"][k], v))


def test_streams_agree_with_vitta_tpus_engine(weights, runs):
    sd, variables, src = weights
    jcfg = W.streams_cfg(jax_preset)
    jeng = JaxEngine(JaxTANet(num_classes=W.K, clip_length=W.T, dropout=0.0),
                     jcfg, variables, src, donate=False)
    eng = _port_engine(weights)
    key = jax.random.PRNGKey(0)
    for i in range(W.S):
        g, r = _where(i)
        worker = runs["streams"][r]
        data = W.ArrayStreamDataset(i)
        jstate = jeng.init_state()
        for bi in range(W.N_VIDEOS):
            views, clip, label = data[bi]
            jstate, jm = jeng.adapt_eval_step(
                jstate, jnp.asarray(views), jnp.asarray(clip),
                jnp.asarray(label), jax.random.fold_in(key,
                                                       r * W.N_VIDEOS + bi))
            got = worker["steps"][g * W.N_VIDEOS + bi]
            for f in W.LOSSES:
                np.testing.assert_allclose(got[f], float(getattr(jm, f)),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"stream {i} {bi} {f}")
            assert got["top1"] == float(jm.top1)
        eng.init_state()
        with torch.no_grad():
            for k, p in eng.model.named_parameters():
                p.copy_(worker["finals"][g]["params"][k])
        assert tm.assert_params_close(eng, jstate, sd) > 100


def test_world_of_one(weights):
    """Without a process group a group of one stream runs in this process,
    the single-stream engine's trajectory bit for bit; a group larger than
    the world raises."""
    assert mesh.world_size() == 1 and mesh.rank() == 0
    eng = _port_engine(weights)
    data = W.ArrayStreamDataset(0)
    rows, state = run_parallel_streams(eng, [data], seed=5)
    params = {k: p.detach().clone() for k, p in state.params.items()}
    state = eng.init_state()
    top1 = []
    for bi in range(W.N_VIDEOS):
        eng.generator.manual_seed(stream_video_seed(5, 0, W.N_VIDEOS, bi))
        state, m = eng.adapt_eval_step(state, *data[bi])
        top1.append(float(m.top1))
    assert rows == [np.mean(top1)]
    assert all(torch.equal(params[k], p) for k, p in state.params.items())
    spe = StreamParallelEngine(eng, 1)
    assert spe.gather_metrics(torch.tensor([1.0, 2.0])).tolist() == \
        [[1.0, 2.0]]
    with pytest.raises(ValueError, match="2 processes"):
        StreamParallelEngine(eng, 2)
    with pytest.raises(ValueError, match="equal length"):
        run_parallel_streams(eng, [data, list(range(3))])


def test_parallel_sweep_killed_and_resumed_matches_uninterrupted(runs):
    plain, resumed = runs["plain"], runs["resume"]
    # both ranks hold the same rows, and the resumed sweep the
    # uninterrupted one's
    for phase in (plain, resumed):
        assert phase[0]["rows"] == phase[1]["rows"]
    assert resumed[0]["rows"] == plain[0]["rows"]
    assert set(plain[0]["rows"]) == {*W.SWEEP_CORRUPTIONS, "mean"}
    # the kill came after video 0 of the first group (gauss, contrast):
    # each rank's own state file, rank 0's marker with per-stream meters
    ak = runs["after_kill"]
    assert ak["manifest"] == {"corruptions": W.SWEEP_CORRUPTIONS[:2]}
    assert ak["files"] == ["latest.json", "manifest.json", "step_1",
                           "step_1/rank_0.pt", "step_1/rank_1.pt"]
    assert ak["latest"]["next_bi"] == 1
    assert all(len(s) == 2 and c == 1
               for s, c in ak["latest"]["meters"].values())
    # from the resume point on, every step the uninterrupted run's: rank 0
    # resumes its first stream at video 1 and runs the second group's
    # stream, rank 1 resumes and then idles
    for r in range(2):
        want = plain[r]["steps"][1:]
        assert resumed[r]["steps"] == want, r
    assert len(plain[0]["steps"]) == 2 * W.SWEEP_VIDEOS
    assert len(plain[1]["steps"]) == W.SWEEP_VIDEOS
    # rank 0 alone wrote the sweep's files; the checkpoints are gone
    for d in (runs["plain_dir"], runs["cut_dir"]):
        state = json.loads((d / "sweep_state.json").read_text())
        assert state == {k: v for k, v in plain[0]["rows"].items()
                         if k != "mean"}
        assert not list(d.glob("stream_ckpt_group_*"))
    assert len(list(runs["plain_dir"].glob("*_all_result"))) == 1


def test_sharded_validate_matches_vitta_tpu_and_the_source_baseline(runs):
    from vitta_tpu.cli.opts import get_opts as jax_get_opts
    from vitta_tpu.data.dataset import TANetVideoDataset as JaxDataset
    from vitta_tpu.data.video_reader import SyntheticVideoSource as JaxSource
    from vitta_tpu.models.tanet import TANet
    from vitta_tpu.parallel.data_eval import sharded_validate
    from vitta_tpu.parallel.mesh import make_mesh
    from vitta_tpu_torch.baselines import setup_baseline
    from vitta_tpu_torch.cli.main_eval import load_variables
    from vitta_tpu_torch.data.dataset import TANetVideoDataset
    from vitta_tpu_torch.data.video_reader import SyntheticVideoSource

    got = [tuple(r["validate"]) for r in runs["plain"]]
    assert got[0] == got[1]
    cfg = W.sweep_cfg("", resume=False)
    sd = load_variables(cfg, seed=cfg.runtime.seed)
    ds = TANetVideoDataset(cfg, SyntheticVideoSource(48, 64, 50),
                           W.sweep_records(W.EVAL_VIDEOS), dataset_type="eval")
    ref = setup_baseline("source", get_model(cfg), cfg, sd,
                         device="cpu").run(ds, batch_size=2)
    # some videos right and some wrong, or the comparison could not fail
    assert 0 < ref < 100 and got[0][0] == ref
    _a, jcfg = jax_get_opts(["--clip_length", "2", "--input_size", "32",
                             "--scale_size", "40"])
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                  num_classes=W.K))
    jds = JaxDataset(jcfg, JaxSource(48, 64, 50),
                     W.sweep_records(W.EVAL_VIDEOS), dataset_type="eval")
    want = sharded_validate(TANet(num_classes=W.K, clip_length=2),
                            convert_tanet_checkpoint(sd, W.K), jds,
                            make_mesh(1, ("data",)), jcfg, batch_size=2)
    assert got[0] == tuple(want)


def test_stream_device_maps_ranks_to_cards(monkeypatch):
    monkeypatch.setenv("VITTA_PLATFORM", "cpu")
    assert mesh.stream_device(3, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="at least 1"):
        mesh.stream_device(0, 0)
    monkeypatch.delenv("VITTA_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.stream_device(0, 1)
    # a host of one card: two streams share it at streams_per_chip 2; a
    # second card is never made up, nor the CPU fallen back to
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert [mesh.stream_device(r, 2) for r in (0, 1)] == \
        [torch.device("cuda", 0)] * 2
    assert chosen == [0, 0]
    for r, spc in ((1, 1), (2, 2), (4, 3)):
        with pytest.raises(RuntimeError, match="needs card"):
            mesh.stream_device(r, spc)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.stream_device(7, 2) == torch.device("cuda", 3)


def test_entry_and_multiprocess_dry_run(monkeypatch):
    from vitta_tpu_torch import entry
    monkeypatch.setenv("VITTA_PLATFORM", "cpu")
    fn, args = entry.entry()
    out = fn(*args)
    assert out.shape == (2, 101) and bool(torch.isfinite(out).all())
    losses = entry.dryrun_multichip(2, timeout_s=WAIT_S)
    assert len(losses) == 2 and losses[0] != losses[1]
