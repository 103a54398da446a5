"""The port's six baselines (vitta_tpu_torch/baselines) against
vitta_tpu's on the CPU, from the same weights and the same videos: the
full-width ResNet-50+TAM TANet of tests/torch_engine_modes.py (weights of
the reference's torch TSN, carried to vitta_tpu by
``convert_tanet_checkpoint``), 5 classes, dropout 0, over the eval
datasets of both packages on ``SyntheticVideoSource`` (bit-equal frames).

T = 4 frames of 64 x 64, batches of 2 videos: TENT and NORM normalize with
the batch's statistics, and at T = 2 and 32 x 32 layer4 sees 4 values a
channel, where that mode is ill-conditioned in any implementation
(ROADMAP.md queue 3); here it sees 2 x 4 x 2 x 2 = 32.

Tolerances: logits and running statistics rtol 1e-4 / atol 1e-5 of their
largest magnitude (float32 convolutions summed in other orders), rtol 1e-3
where the forward normalizes with the batch's statistics (NORM, TENT),
which amplify those differences; TENT's first-step loss rtol 1e-4, its
gradients within 4 times their own one-ulp spread (see its test), then the
updates after the adaptation pass within 5% of their norm at the median
tensor, 10% as a whole and 75% each (tests/test_torch_bf16_modes.py's
EACH: Adam's steps are about lr * sign(g), so an element whose gradient is
rounding noise moves either way), and torch's Adam against optax's on the
same gradients to rtol 2e-5; every top-1 exactly; SHOT's pseudo-labels, DUA's augmented
batches and T3A's predictions exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_engine_modes as tm
from tests.test_torch_bf16_modes import EACH
from vitta_tpu.baselines import setup_baseline as jax_setup_baseline
from vitta_tpu.config import tanet_ucf101_preset as jax_preset
from vitta_tpu.data import dataset as jax_dataset
from vitta_tpu.data.records import VideoRecord as JaxVideoRecord
from vitta_tpu.data.video_reader import \
    SyntheticVideoSource as JaxSyntheticVideoSource
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu_torch.adapt.optim import norm_affine_mask
from vitta_tpu_torch.baselines import setup_baseline
from vitta_tpu_torch.baselines.common import batched_eval_iter
from vitta_tpu_torch.baselines.t3a import _entropy as t3a_entropy
from vitta_tpu_torch.baselines.tent import TENT_BETA, TENT_LR
from vitta_tpu_torch.config import tanet_ucf101_preset
from vitta_tpu_torch.data import dataset, transforms
from vitta_tpu_torch.data.records import VideoRecord
from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax

torch.set_num_threads(1)

T, HW, K = 4, 64, tm.K
BATCH = 2
N_VIDEOS = 4
SOURCE_HW = (72, 96)
RTOL, ATOL = 1e-4, 1e-5
BN_RTOL = 1e-3      # forwards that normalize with the batch's statistics
LOSS_TOL = 1e-4
SPREAD = 4.0        # TENT's gradients: times their own one-ulp spread
ADAM_MEDIAN, ADAM_WHOLE = 0.05, 0.1   # TENT's updates (see its test)


def _cfg(preset):
    cfg = preset()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                 scale_size=HW + 8),
        model=dataclasses.replace(cfg.model, num_classes=K, dropout=0.0))


@pytest.fixture(scope="module")
def shared():
    sd, variables = tm.tanet_weights(T)
    jcfg, cfg = _cfg(jax_preset), _cfg(tanet_ucf101_preset)
    names = [(f"b{i}", 40 + 5 * i, i % K) for i in range(N_VIDEOS)]
    jds = jax_dataset.TANetVideoDataset(
        jcfg, JaxSyntheticVideoSource(*SOURCE_HW),
        [JaxVideoRecord(*n) for n in names], dataset_type="eval")
    ds = dataset.TANetVideoDataset(
        cfg, SyntheticVideoSource(*SOURCE_HW),
        [VideoRecord(*n) for n in names], dataset_type="eval")
    np.testing.assert_array_equal(ds[1].frames, jds[1].frames)
    jmodel = JaxTANet(num_classes=K, clip_length=T, dropout=0.0)
    return dict(sd=sd, variables=variables, jcfg=jcfg, cfg=cfg, jds=jds,
                ds=ds, jmodel=jmodel)


def pair(shared, name, **kw):
    """(vitta_tpu's baseline, the port's on the CPU)."""
    jb = jax_setup_baseline(name, shared["jmodel"], shared["jcfg"],
                            shared["variables"], **kw)
    b = setup_baseline(name, get_model(shared["cfg"]), shared["cfg"],
                       shared["sd"], device="cpu", **kw)
    return jb, b


def batches(shared):
    return list(batched_eval_iter(shared["ds"], BATCH))


def assert_scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=ATOL * scale,
                               err_msg=what)


def running_stats(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def jax_running_stats(variables):
    sd = tanet_state_dict_from_jax(variables)
    return {k: v.numpy() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def assert_stats(got, want, tol=RTOL):
    assert got.keys() == want.keys() and len(got) > 100
    for k, w in want.items():
        assert_scaled(got[k], w, tol, k)


def test_source_logits_and_top1(shared):
    jb, b = pair(shared, "source")
    for clips, _labels in batches(shared):
        want = jb._fwd(jb.variables, jnp.asarray(clips))
        with torch.no_grad():
            got = b.model(torch.from_numpy(clips), None, train=False)
        assert_scaled(got.numpy(), want, RTOL, "source logits")
    assert b.run(shared["ds"], BATCH) == jb.run(shared["jds"], BATCH)
    # the model is left as it was given
    assert_stats(running_stats(b.model), jax_running_stats(jb.variables))


def test_norm_logits_running_stats_and_top1(shared):
    jb, b = pair(shared, "norm")
    variables = dict(jb.variables)
    b.reset()
    for clips, _labels in batches(shared):
        want, mutated = jb._fwd(variables, jnp.asarray(clips))
        variables = {"params": variables["params"],
                     "batch_stats": mutated["batch_stats"]}
        with torch.no_grad():
            got = b.model(torch.from_numpy(clips), None, train=False,
                          use_running_average=False,
                          update_running_stats=True)
        assert_scaled(got.numpy(), want, BN_RTOL, "norm logits")
    assert_stats(running_stats(b.model), jax_running_stats(variables),
                 BN_RTOL)
    assert b.run(shared["ds"], BATCH) == jb.run(shared["jds"], BATCH)
    assert_stats(running_stats(b.model), jax_running_stats(variables),
                 BN_RTOL)


def _first_gradient(opt_state, params):
    """vitta_tpu's first TENT gradient, read back from its Adam state after
    one step: the first moment is then (1 - b1) g; zeros where the mask
    freezes a parameter."""
    found = []
    jax.tree_util.tree_flatten(opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState) and not found.append(x))
    (adam,) = found
    mu = dict(jax.tree_util.tree_flatten_with_path(adam.mu)[0])
    return jax.tree_util.tree_map_with_path(
        lambda path, p: mu[path] / (1 - TENT_BETA) if path in mu
        else jnp.zeros_like(p), params)


def nudged(sd, names):
    """``sd`` with each of the tensors ``names`` moved by one float32 ulp
    (a seeded random sign a element)."""
    gen = torch.Generator().manual_seed(1)
    out = dict(sd)
    for k in names:
        sign = torch.rand(sd[k].shape, generator=gen) < 0.5
        out[k] = sd[k] * (1.0 + torch.where(sign, -1.0, 1.0) * 2.0 ** -23)
    return out


def _port_tent_grads(b, x, nudge=False):
    """The port's TENT loss and its gradients ({name: array}) from the
    given weights, or from ``nudged`` ones."""
    b.reset()
    if nudge:
        names = [k for k, _p in b.model.named_parameters()]
        b.model.load_state_dict(nudged(b.state_dict, names))
    trained, _optimizer = b._optimizer()
    names = {id(p): n for n, p in b.model.named_parameters()}
    loss = b._loss(x)
    loss.backward(inputs=trained)
    return float(loss.detach()), {names[id(p)]: p.grad.numpy().copy()
                                  for p in trained}


def _gaps(got, want):
    """(per-tensor |got - want| / |want|, whole-gradient gap)."""
    each = [np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            for k in want]
    whole = (np.linalg.norm([np.linalg.norm(got[k] - want[k]) for k in want])
             / np.linalg.norm([np.linalg.norm(want[k]) for k in want]))
    return np.asarray(each), whole


def test_tent_gradients_updates_and_top1(shared):
    """The first step's loss against vitta_tpu's at rtol 1e-4.  Its
    gradients under batch-statistics BatchNorm are ill-conditioned at every
    size a CPU test can run (random weights; T 4 and 8, 64 and 112 px): the
    port's own gradients one float32 ulp of the weights away differ by a
    median 0.5-0.9% a tensor.  So each gradient gap to vitta_tpu (median,
    worst tensor, whole) is held to SPREAD times that spread, measured here
    on the same batch.  Adam's first steps are about lr * sign(g), so every
    element whose gradient lies within that noise moves by lr either way:
    after the adaptation pass (two steps) the port's updates are a median
    3.6% of their norm from vitta_tpu's (7.0% of the whole update), 5 times
    the port's own spread one ulp away, where the gradients' gap was 2
    times it.  The updates are held to ADAM_MEDIAN and ADAM_WHOLE, every
    tensor's to EACH, nothing but the norm layers' weight and bias moves,
    and ``test_adam_matches_optax`` holds the optimizer itself.

    An rtol of 1e-4 on the gradients cannot hold where one ulp moves
    them by 0.6%.  What the bounds sit below: with a fault planted in the
    port (BatchNorm normalizing with the unbiased variance or with eps
    1e-3, or its batch statistics detached from the gradient) the gradient
    gaps read 134-1422 (median), 106-720 (worst) and 149-2269 (whole)
    times the spread, and the updates 1.15-1.30 (median), 0.94-1.16
    (whole) and 1.83-1.99 (worst) of their norm; the correct port reads
    2.1, 1.3 and 2.3 times, then 0.035, 0.070 and 0.54."""
    jb, b = pair(shared, "tent")
    data = batches(shared)
    params, stats = jb.variables["params"], jb.variables["batch_stats"]
    # vitta_tpu's adaptation pass, as TentBaseline.run makes it; its first
    # step's loss and gradient
    opt_state = jb.tx.init(params)
    losses = []
    for i, (clips, _labels) in enumerate(data):
        params, stats, opt_state, jloss = jb._adapt(params, stats, opt_state,
                                                    jnp.asarray(clips))
        losses.append(float(jloss))
        if i == 0:
            want_grads = {k: v.numpy() for k, v in tanet_state_dict_from_jax(
                {"params": _first_gradient(opt_state, params),
                 "batch_stats": stats}).items()}
    x0 = torch.from_numpy(data[0][0])
    loss, grads = _port_tent_grads(b, x0)
    _loss, ulp_grads = _port_tent_grads(b, x0, nudge=True)
    np.testing.assert_allclose(loss, losses[0], rtol=LOSS_TOL)
    mask = norm_affine_mask(b.model.named_parameters())
    # only the norm layers' weight and bias are trained
    assert set(grads) == {k for k, m in mask.items() if m}
    assert len(grads) > 100
    got, whole = _gaps(grads, {k: want_grads[k] for k in grads})
    spread, whole_spread = _gaps(ulp_grads, grads)
    assert np.median(got) <= SPREAD * np.median(spread), \
        (np.median(got), np.median(spread))
    assert got.max() <= SPREAD * spread.max(), (got.max(), spread.max())
    assert whole <= SPREAD * whole_spread, (whole, whole_spread)

    want = tanet_state_dict_from_jax({"params": params, "batch_stats": stats})
    top1 = b.run(shared["ds"], BATCH)
    names = [k for k, m in mask.items() if m]
    init = shared["sd"]
    got = {k: p.detach().numpy() - init[k].numpy()
           for k, p in b.model.named_parameters()}
    for k in mask:
        if not mask[k]:
            assert not got[k].any(), k
            assert np.array_equal(want[k].numpy(), init[k].numpy()), k
    gap, whole = _gaps({k: got[k] for k in names},
                       {k: want[k].numpy() - init[k].numpy() for k in names})
    assert gap.max() <= EACH, (gap.max(), EACH)
    assert np.median(gap) <= ADAM_MEDIAN, np.median(gap)
    assert whole <= ADAM_WHOLE, whole
    assert_stats(running_stats(b.model), jax_running_stats(
        {"params": params, "batch_stats": stats}), BN_RTOL)
    assert top1 == jb.run(shared["jds"], BATCH)


def test_adam_matches_optax():
    """TENT's optimizer: ``torch.optim.Adam(lr 1e-5, betas (0.9, 0.999),
    eps 1e-8)`` against ``optax.adam`` on the same gradients over three
    steps, from zero weights (so that an update is not lost in the
    weights' rounding): bias-corrected moments, eps outside the square
    root of the second (the first gradients ~1e-4, where eps = 1e-8 inside
    the root would shrink the step by 29%), the same updates to rtol 2e-5:
    optax forms 1 - b^t in float32 (0.999 is 0.99899995 there) and torch in
    float64, which moves a step by up to 7e-6 of its size."""
    rng = np.random.default_rng(0)
    grads = [(rng.normal(size=(4, 6)) * scale).astype(np.float32)
             for scale in (1e-4, 1.0, 30.0)]
    tx = optax.adam(TENT_LR, b1=TENT_BETA, b2=0.999)
    jp = jnp.zeros((4, 6), jnp.float32)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.zeros(4, 6))
    opt = torch.optim.Adam([tp], lr=TENT_LR, betas=(TENT_BETA, 0.999),
                           eps=1e-8)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=2e-5, atol=0)


def test_shot_pseudo_labels(shared):
    jb, b = pair(shared, "shot")
    want = jb._pseudo_labels(shared["jds"], jb.variables, BATCH)
    b.reset()
    got = b.pseudo_labels(shared["ds"], BATCH)
    np.testing.assert_array_equal(got, want)


def test_dua_batches_stats_and_top1(shared):
    jb, b = pair(shared, "dua")
    cfg = shared["cfg"]
    raw = dataset.TANetVideoDataset(cfg, shared["ds"].source,
                                    shared["ds"].records, dataset_type="raw",
                                    emit_uint8=True)
    jraw = jax_dataset.TANetVideoDataset(
        shared["jcfg"], shared["jds"].source, shared["jds"].records,
        dataset_type="raw", emit_uint8=True)
    jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
    b.reset()
    variables = dict(jb.variables)
    for i in range(2):
        clip = raw[i].frames
        np.testing.assert_array_equal(clip, jraw[i].frames)
        got = b.augment_batch(clip, rng)
        want = jb._augment_batch(clip, jrng)
        assert got.shape == (16, T, HW, HW, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        batch = transforms.normalize_clip(got, cfg.data.input_mean,
                                          cfg.data.input_std)
        b.update_stats(batch)
        new = jb._update(variables, jnp.asarray(batch))
        variables = {"params": variables["params"],
                     "batch_stats": new["batch_stats"]}
    assert_stats(running_stats(b.model), jax_running_stats(variables))
    assert b.run(raw, shared["ds"], BATCH, no_vids=1, seed=3) == \
        jb.run(jraw, shared["jds"], BATCH, no_vids=1, seed=3)


def test_t3a_supports_and_predictions(shared):
    jb, b = pair(shared, "t3a", filter_k=2)
    twin = setup_baseline("t3a", get_model(shared["cfg"]), shared["cfg"],
                          shared["sd"], device="cpu", filter_k=2)
    b.reset()
    b.init_supports()
    # the same host logic on vitta_tpu's features and logits
    w = np.asarray(jb.variables["params"]["new_fc"]["kernel"]).T
    np.testing.assert_allclose(b.supports, w, rtol=0, atol=0)
    warm = np.asarray(jb._cls(jb.variables, jnp.asarray(w)))
    twin.supports, twin.labels, twin.ents = (
        w, np.eye(K, dtype=np.float32)[warm.argmax(1)], t3a_entropy(warm))
    np.testing.assert_array_equal(b.labels, twin.labels)
    e = b.n_eval_views
    for clips, _y in batches(shared):
        jz = jb._feat(jb.variables, jnp.asarray(clips))
        jz = np.asarray(jz.reshape(jz.shape[0] // e, e, -1).mean(1))
        jp = np.asarray(jb._cls(jb.variables, jnp.asarray(jz)))
        with torch.no_grad():
            z = b.model.features(torch.from_numpy(clips))
            z = z.reshape(z.shape[0] // e, e, -1).mean(dim=1)
            p = b.model.classify(z).numpy()
        assert_scaled(z.numpy(), jz, RTOL, "t3a features")
        assert_scaled(p, jp, RTOL, "t3a logits")
        pred = b.adjust(z.numpy(), p)
        np.testing.assert_array_equal(pred, twin.adjust(jz, jp))
        np.testing.assert_array_equal(b.labels, twin.labels)
        assert_scaled(b.supports, twin.supports, RTOL, "t3a supports")
    assert b.run(shared["ds"], BATCH) == jb.run(shared["jds"], BATCH)
