"""The loader chain end to end on the CPU: the port's ``tta_stream`` over
``Prefetcher(PairedTTADataset(SyntheticVideoSource), device="cpu")``
against vitta_tpu's ``tta_stream`` over its own
``Prefetcher(PairedTTADataset(SyntheticVideoSource), device_put=False)``,
from the same weights, source statistics, list of videos and seeds, on the
tiny TANet of tests/torch_engine_modes.py (T = 2, 32 x 32) and the tiny
Video Swin of tests/test_torch_swin_engine.py (T = 4, 24 x 24), dropout and
drop-path 0; then ``validate`` over the eval dataset's ``Sample`` items.

Tolerances are those of tests/test_torch_engine.py and
tests/test_torch_swin_engine.py: each step's losses rtol 1e-3 / atol 1e-5,
top-1 exactly, the EMA rtol 1e-3 / atol 1e-5, each parameter's update to
2% of its norm.  The frames are bit-equal (tests/test_torch_data_datasets
.py), so what differs is only the engines' arithmetic.
"""

import numpy as np
import torch

from tests import test_torch_swin_engine as se
from tests import torch_engine_modes as tm
from tests.test_torch_swin_engine import weights  # noqa: F401 (a fixture)
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.loops import tta_stream as jax_tta_stream
from vitta_tpu.adapt.loops import validate as jax_validate
from vitta_tpu.config import swin_ucf101_preset as jax_swin_preset
from vitta_tpu.data import dataset as jax_dataset
from vitta_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from vitta_tpu.data.video_reader import \
    SyntheticVideoSource as JaxSyntheticVideoSource
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu_torch.adapt.loops import tta_stream, validate
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.data import dataset
from vitta_tpu_torch.data.pipeline import Prefetcher
from vitta_tpu_torch.data.records import VideoRecord
from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
from vitta_tpu_torch.models.swin import Recognizer3D

torch.set_num_threads(1)

RECORDS = [VideoRecord(f"stream_{i}", 24 + 9 * i, i % tm.K)
           for i in range(3)]
H, W = 48, 64


class Steps:
    """A metrics writer keeping each video's losses and running top-1."""

    def __init__(self):
        self.values = {}

    def scalar(self, tag, value, step):
        self.values.setdefault(tag, []).append(float(value))


def _run_both(jeng, jcfg, eng, cfg, dataset_name, n_workers=2):
    kw = dict(seed=5, emit_uint8=True)
    jpaired = jax_dataset.PairedTTADataset(
        jcfg, JaxSyntheticVideoSource(H, W), RECORDS,
        dataset_cls=getattr(jax_dataset, dataset_name), **kw)
    paired = dataset.PairedTTADataset(
        cfg, SyntheticVideoSource(H, W), RECORDS,
        dataset_cls=getattr(dataset, dataset_name), **kw)
    jsteps, steps = Steps(), Steps()
    jtop1, jstate, jmeters = jax_tta_stream(
        jeng, JaxPrefetcher(jpaired, device_put=False, n_workers=n_workers),
        seed=0, metrics_writer=jsteps)
    top1, state, meters = tta_stream(
        eng, Prefetcher(paired, device="cpu", n_workers=n_workers), seed=0,
        metrics_writer=steps)
    assert state.step == int(jstate.step) == len(RECORDS)
    assert top1 == jtop1
    for tag in ("tta/loss_reg", "tta/loss_consis"):
        np.testing.assert_allclose(steps.values[tag], jsteps.values[tag],
                                   rtol=tm.RTOL, atol=tm.ATOL, err_msg=tag)
    assert steps.values["tta/top1_avg"] == jsteps.values["tta/top1_avg"]
    np.testing.assert_allclose(meters["loss_ce"].avg, jmeters["loss_ce"].avg,
                               rtol=tm.RTOL, atol=tm.ATOL)
    tm.assert_ema_close(state.ema, jstate.ema)
    return state, jstate


def _validate_both(jeng, jcfg, eng, cfg, dataset_name, params, jparams):
    kw = dict(dataset_type="eval", seed=1, emit_uint8=True)
    jds = getattr(jax_dataset, dataset_name)(
        jcfg, JaxSyntheticVideoSource(H, W), RECORDS, **kw)
    ds = getattr(dataset, dataset_name)(cfg, SyntheticVideoSource(H, W),
                                        RECORDS, **kw)
    items = list(Prefetcher(ds, device="cpu"))
    assert all(type(s).__name__ == "Sample" for s in items)
    jitems = [jds[i] for i in range(len(jds))]
    for p, jp in ((None, None), (params, jparams)):
        assert validate(eng, items, params=p) == jax_validate(jeng, jitems,
                                                              params=jp)
    # the same as (clip, label) pairs
    pairs = [(s.frames, np.asarray([s.label])) for s in items]
    assert validate(eng, pairs, params=params) == validate(eng, items,
                                                           params=params)


def test_tanet_chain_matches_vitta_tpu():
    t = 2
    sd, variables = tm.tanet_weights(t)
    src = tm.mean_var_source(variables, t)
    jeng, eng = tm.engines(sd, variables, src, t)
    jcfg = tm.cfg_of(tm.jax_preset, t)
    cfg = tm.cfg_of(tm.tanet_ucf101_preset, t)
    state, jstate = _run_both(jeng, jcfg, eng, cfg, "TANetVideoDataset")
    assert tm.assert_params_close(eng, jstate, sd) >= 100
    _validate_both(jeng, jcfg, eng, cfg, "TANetVideoDataset", state.params,
                   jstate.params)


def test_swin_chain_matches_vitta_tpu(weights):
    sd, variables, src = weights
    jcfg, cfg = se._cfg(jax_swin_preset), se._cfg(swin_ucf101_preset)
    jeng = JaxEngine(JaxRecognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                     **se.MODEL_KW), jcfg, variables, src,
                     donate=False)
    eng = se._port_engine(weights)
    state, jstate = _run_both(jeng, jcfg, eng, cfg, "SwinVideoDataset")
    se._compare_params(eng, jstate, sd, step=len(RECORDS) - 1)
    _validate_both(jeng, jcfg, eng, cfg, "SwinVideoDataset", state.params,
                   jstate.params)
