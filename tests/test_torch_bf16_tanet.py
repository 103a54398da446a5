"""The port's TANet at bfloat16 against vitta_tpu's TANet(dtype="bfloat16")
on the CPU, through the same float32 weights (tests/torch_tanet.py's oracle,
as tests/test_torch_tanet.py), and ``get_model``'s dispatch of
``compute_dtype``.

Tolerances, and why. Both packages' bfloat16 forwards round 50 layers of
activations, each a conv's bfloat16 output summed in float32 in its own
order (oneDNN against XLA:CPU): a value one conv rounds up the other may
round down, and the difference travels. vitta_tpu's forward runs op by op
here, so that every op rounds its output as the program says; compiled as
one program, XLA:CPU drops some of the bfloat16 roundings between fused ops
(its float32 and bfloat16 statistics then stand closer than the roundings
the program asks for would leave them). At T = 4 and 32 x 32 the layer4
statistics reduce over 8 positions and their variances cancel, so bfloat16
alone moves vitta_tpu's own statistics by up to a third of their largest
value against its float32 forward. So each tap and the logits are held to
``BF16_FACTOR`` (3) times that move: two forwards that round at the same
points may sit on either side of the float32 one, each about as far from it
(measured: at most 1.4 times, at layer3's and layer4's variances). What
that leaves open is held by itself: the activations are bfloat16 and
everything else float32 (the dtypes), the bfloat16 forward is not the
float32 one, and the stem's statistics (one conv) agree to rtol 2e-3 / atol
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt import precompute as jax_pre
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.adapt import precompute as pre
from vitta_tpu_torch.config import swin_ucf101_preset, tanet_ucf101_preset
from vitta_tpu_torch.models import get_model
from vitta_tpu_torch.models.layers import BatchNorm, Taps
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.models.tanet import TANet

torch.set_num_threads(1)

T, K, HW = 4, 7, 32
BF16_FACTOR = 3.0
STEM = "base_model.bn1"


def _jax_forward(variables, dtype, x, jit):
    """(logits, {tap name: {leaf: (mean, var) or count}}) of vitta_tpu's
    TANet at ``dtype``, compiled as one program or run op by op."""
    jm = JaxTANet(num_classes=K, clip_length=T, dtype=dtype)
    apply = lambda v, c: jm.apply(v, c, train=False, mutable=["taps"])
    logits, aux = (jax.jit(apply) if jit else apply)(variables,
                                                     jnp.asarray(x))
    taps = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            aux["taps"], is_leaf=lambda v: hasattr(v, "mean"))[0]:
        keys = [p.key for p in path if hasattr(p, "key")]
        value = (leaf if keys[-1] == "stat_n"
                 else (np.asarray(leaf.mean), np.asarray(leaf.var)))
        taps.setdefault(".".join(keys[:-1]), {})[keys[-1]] = value
    return np.asarray(logits), taps


@pytest.fixture(scope="module")
def shared():
    torch.manual_seed(0)
    oracle = TorchTSN(K, T)
    with torch.no_grad():
        randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    variables = convert_tanet_checkpoint(sd, K)
    x = np.random.default_rng(0).normal(size=(2, T, HW, HW, 3)).astype(
        np.float32)
    return dict(sd=sd, variables=variables, x=x,
                jax32=_jax_forward(variables, "float32", x, jit=True),
                jax16=_jax_forward(variables, "bfloat16", x, jit=False))


def _port(sd, dtype):
    model = TANet(K, clip_length=T, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _assert_near(got, want, ref, what, floor=0.0):
    """max|got - want| <= max(BF16_FACTOR * max|want - ref|, floor *
    max|ref|)."""
    got, want, ref = (np.asarray(a, np.float64) for a in (got, want, ref))
    move = float(np.abs(want - ref).max())
    err = float(np.abs(got - want).max())
    assert err <= max(BF16_FACTOR * move, floor * float(np.abs(ref).max())), (
        f"{what}: {err:.3e} from vitta_tpu at bfloat16, which is "
        f"{move:.3e} from its float32 forward")


def test_logits_and_taps_match_jax_bf16(shared):
    model = _port(shared["sd"], "bfloat16")
    taps = {}
    with torch.no_grad():
        logits = model(torch.from_numpy(shared["x"]), taps)
    (l16, t16), (l32, t32) = shared["jax16"], shared["jax32"]
    assert logits.dtype == torch.float32
    _assert_near(logits.numpy(), l16, l32, "logits")
    assert set(taps) == set(t16)
    for name, leaves in taps.items():
        assert set(leaves) == set(t16[name]), name
        for leaf, value in leaves.items():
            if leaf == "stat_n":
                assert value == float(t16[name][leaf]), name
                continue
            for i, part in enumerate(value):
                assert part.dtype == torch.float32, (name, leaf)
                _assert_near(part.numpy(), t16[name][leaf][i],
                             t32[name][leaf][i], f"{name}.{leaf}[{i}]")
    for i in range(2):   # the stem: one conv and its BatchNorm
        np.testing.assert_allclose(taps[STEM]["stat"][i].numpy(),
                                   t16[STEM]["stat"][i], rtol=2e-3,
                                   atol=1e-4)


def test_activations_are_bf16_and_the_rest_float32(shared):
    model = _port(shared["sd"], "bfloat16")
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    outputs = {}

    def record(module, args, out):
        outputs[module.tap_name] = (args[0].dtype, out.dtype)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(record)
    taps = {}
    x = torch.from_numpy(shared["x"]).requires_grad_()
    logits = model(x, taps)
    assert len(outputs) == 53 + 32   # 53 BatchNorm2d, 2 BatchNorm1d a TAM
    for name, dtypes in outputs.items():
        tam_branch = name.endswith(("g_bn", "l_bn"))
        want = torch.float32 if tam_branch else torch.bfloat16
        assert dtypes == (want, want), name
    (logits.sum() + sum(v["stat"].var.sum() for v in taps.values())).backward()
    assert x.grad.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    # and the bfloat16 forward is not the float32 one
    with torch.no_grad():
        l32 = _port(shared["sd"], "float32")(torch.from_numpy(shared["x"]))
    assert not torch.equal(logits.detach(), l32)


def _cfg(arch_preset, dtype, **model_kw):
    cfg = arch_preset()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype=dtype, **model_kw))


def test_get_model_dispatches_compute_dtype():
    model = get_model(_cfg(tanet_ucf101_preset, "bfloat16", num_classes=K))
    assert isinstance(model, TANet) and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert get_model(_cfg(tanet_ucf101_preset, "float32")).dtype == \
        torch.float32
    for bad in ("float16", "float64"):
        with pytest.raises(NotImplementedError, match="compute_dtype"):
            get_model(_cfg(tanet_ucf101_preset, bad))
    with pytest.raises(ValueError, match="bfloat16"):
        TANet(K, clip_length=T, dtype="float16")


def test_get_model_builds_swin_at_float32_under_bf16():
    """vitta_tpu/models/__init__.py:14-23 hands Swin no dtype: under
    compute_dtype "bfloat16" the model is the float32 one."""
    kw = dict(num_classes=K, patch_size=(2, 4, 4), window_size=(2, 3, 3),
              embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
              drop_path_rate=0.0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 4, 24, 24, 3)).astype(np.float32))
    out = {}
    for dtype in ("float32", "bfloat16"):
        torch.manual_seed(0)
        model = get_model(_cfg(swin_ucf101_preset, dtype, **kw))
        assert isinstance(model, Recognizer3D)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        taps = {}
        with torch.no_grad():
            out[dtype] = (model(x, taps), taps)
    assert out["bfloat16"][0].dtype == torch.float32
    assert torch.equal(out["bfloat16"][0], out["float32"][0])
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        get_model(_cfg(swin_ucf101_preset, "float16", **kw))


def test_source_statistics_match_jax_bf16(shared):
    """compute_source_statistics at bfloat16 over the clip (one batch):
    float32 statistics of every norm layer, the tapped forward's own, held
    to vitta_tpu's at bfloat16.  vitta_tpu's precompute is one compiled
    program, which keeps some values float32 that the op-by-op forward
    rounds; so each leaf is held to ``BF16_FACTOR`` times the move of
    bfloat16 that the op-by-op forward shows, and where that is below one
    bfloat16 ulp of the leaf's largest value, to one ulp (2^-8; measured:
    at most 1.1e-4 of it, in a TAM's g_bn)."""
    batches = [(shared["x"], np.zeros(2, np.int64))]
    jm = JaxTANet(num_classes=K, clip_length=T, dtype="bfloat16")
    want = jax_pre.compute_source_statistics(jm, shared["variables"],
                                             batches)
    model = _port(shared["sd"], "bfloat16")
    got = pre.compute_source_statistics(model, batches, device="cpu")
    taps = Taps({"stat"})
    with torch.no_grad():
        model(torch.from_numpy(shared["x"]), taps)
    t16, t32 = shared["jax16"][1], shared["jax32"][1]
    assert set(got) == set(want) and got
    for name, (m, v) in got.items():
        assert m.dtype == np.float32 and v.dtype == np.float32
        for i, part in enumerate((m, v)):
            np.testing.assert_array_equal(part, taps[name]["stat"][i].numpy())
            move = t16[name]["stat"][i] - t32[name]["stat"][i]
            _assert_near(part, want[name][i], want[name][i] - move,
                         f"{name}[{i}]", floor=2.0 ** -8)
