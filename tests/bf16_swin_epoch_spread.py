"""The bfloat16 Swin epoch case of tests/test_torch_bf16_swin_modes.py:
the port's adapt-step losses against vitta_tpu's, and the port's own
spread one float32 ulp of the weights away (ROADMAP.md queue 3).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bf16_swin_epoch_spread.py \
        [seeds] [--bias-apart] [--reference-attention] [--half-bf16-ulp]

Prints one JSON object: the three adapt-only steps' (reg, consistency, ce)
losses of vitta_tpu's engine compiled with XLA's excess precision on and
rounded as written (``round_as_written``), of the port, and of the port
from weights moved by one float32 ulp (a random sign an element, one run a
seed); then the largest and the full range of the ulp runs' deviation from
the port per step, and the gap to the reference rounded as written.
``--bias-apart`` runs the port with its bfloat16 qkv, proj and patch
embedding rounding the product before adding the bias, as vitta_tpu's
``nn.Dense`` / ``nn.Conv`` do op by op; ``bias_share`` is the share of a
bfloat16 Dense's outputs that the two orders put one ulp apart.
``--reference-attention`` runs its packed attention rounded as vitta_tpu's
CPU path rounds it (tests/bf16_swin_epoch_layers.py).
``--half-bf16-ulp`` moves the weights by 2^-8 of their value instead of
2^-23: about half of the bfloat16 twins the model multiplies by then move
by one bfloat16 ulp (a float32 ulp moves almost none of them).  About 2
min in all for 12 seeds.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from flax import linen as nn

from tests import test_torch_bf16_swin_engine as bse
from tests import test_torch_bf16_swin_modes as modes
from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.models import swin


def bias_share(seed=0):
    """Share of a bfloat16 Dense's outputs where ``F.linear`` with the bias
    inside differs from flax's (product rounded, then the bias added)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 384)) * 0.1).astype(np.float32)
    b = rng.normal(size=(384,)).astype(np.float32)
    want = np.asarray(nn.Dense(384, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": w, "bias": b}}, jnp.asarray(x)), np.float32)
    got = F.linear(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w.T.copy()).bfloat16(),
                   torch.from_numpy(b).bfloat16()).float().numpy()
    return float(np.mean(got != want))


def _bias_apart():
    """The port's Swin with its bfloat16 products rounded before the bias."""
    def linear(x, w, b=None):
        if x.dtype == torch.bfloat16 and b is not None:
            return F.linear(x, w) + b
        return F.linear(x, w, b)

    def conv3d(x, w, b=None, *a):
        if x.dtype == torch.bfloat16 and b is not None:
            return F.conv3d(x, w, None, *a) + b[:, None, None, None]
        return F.conv3d(x, w, b, *a)

    shim = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                    if not k.startswith("__")})
    shim.linear, shim.conv3d = linear, conv3d
    swin.F = shim


def main(argv):
    seeds = int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 12
    if "--bias-apart" in argv:
        _bias_apart()
    if "--reference-attention" in argv:
        from tests.bf16_swin_epoch_layers import _reference_attention
        _reference_attention()
    step = 2.0 ** (-8 if "--half-bf16-ulp" in argv else -23)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(bse.K, bse.PATCH, bse.EMBED, bse.DEPTHS,
                               bse.HEADS, bse.WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, bse.K, depths=bse.DEPTHS,
                                        window_size=bse.WINDOW)
    src = {n: (np.asarray(s.mean), np.asarray(s.var)) for n, s in
           modes._source(variables, ("spatiotemp",), "stat").items()}
    data = bse._videos()

    def jax_losses(as_written):
        jeng, _eng = modes._engines((sd, variables), src,
                                    as_written=as_written)
        state, out = jeng.init_state(), []
        for i, (views, _clip, label) in enumerate(data):
            state, losses = jeng.adapt_step(
                state, jnp.asarray(views), jnp.asarray(label),
                jax.random.fold_in(jax.random.PRNGKey(0), i))
            out.append([float(v) for v in losses])
        return out

    def port_losses(state_dict):
        _jeng, eng = modes._engines((state_dict, variables), src)
        state, out = eng.init_state(), []
        for views, _clip, label in data:
            state, losses = eng.adapt_step(state, views, label)
            out.append([float(v) for v in losses])
        return out

    res = {"bias_share": bias_share(),
           "jax_excess_on": jax_losses(False),
           "jax_as_written": jax_losses(True), "port": port_losses(sd),
           "port_ulp": []}
    for seed in range(1, seeds + 1):
        gen = torch.Generator().manual_seed(seed)
        moved = dict(sd)
        for k, v in sd.items():
            if v.is_floating_point():
                down = torch.rand(v.shape, generator=gen) < 0.5
                moved[k] = v * (1.0 + torch.where(down, -1.0, 1.0) * step)
        res["port_ulp"].append(port_losses(moved))
    consis = lambda runs: np.array([[s[1] for s in r] for r in runs])
    dev = consis(res["port_ulp"]) - consis([res["port"]])
    res["consistency"] = {
        "ulp_largest_deviation": np.abs(dev).max(0).tolist(),
        "ulp_range": np.ptp(dev, axis=0).tolist(),
        "gap_to_as_written": (consis([res["jax_as_written"]])
                              - consis([res["port"]]))[0].tolist()}
    print(json.dumps(res))


if __name__ == "__main__":
    main(sys.argv)
