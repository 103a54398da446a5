"""Why the bfloat16 Swin-T trajectory checks of the projection-fused routes
(tests/test_torch_bf16_swin_proj.py) miss under VITTA_PATCHIFY_V2: the
port's product patch embedding against its Conv3d, and each against
vitta_tpu, over the checks' own 3-step trajectories.

Prints, first, how many bfloat16 outputs of the patch embedding the two
forms round apart (both sum product and bias in float32 and round once,
in another order of sums), then, per route and step, the relative
differences of loss_ce and loss_reg: Conv3d against vitta_tpu, product
against vitta_tpu, and product against Conv3d (the port against itself).
Where the last is as large as the check's rtol 1e-3, the check cannot
tell the two forms apart from a fault.  ~2 min on one core:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bf16_swin_patchify_spread.py
"""

import os

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import tests.test_torch_bf16_swin_proj as proj
from tests.torch_swin import TorchRecognizer3D
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.models.swin import Recognizer3D as JaxRecognizer3D
from vitta_tpu.utils.checkpoint import convert_swin_checkpoint
from vitta_tpu_torch.adapt.engine import VittaEngine
from vitta_tpu_torch.config import swin_ucf101_preset
from vitta_tpu_torch.models.swin import patchify_mm

MODEL = "t"


def embedding_roundings():
    """(outputs apart, outputs) of the two forms at bfloat16 on a clip of
    Swin-T's test width."""
    torch.manual_seed(0)
    c = proj.MODELS[MODEL]["embed_dim"]
    x = torch.randn(2, proj.T, 32, 32, 3).bfloat16()
    w = (torch.randn(c, 3, *proj.PATCH) * 0.1).bfloat16()
    b = (torch.randn(c) * 0.1).bfloat16()
    conv = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, proj.PATCH).permute(
        0, 2, 3, 4, 1)
    prod = F.linear(patchify_mm(x, proj.PATCH), w.reshape(c, -1), b)
    return int((conv != prod).sum()), conv.numel()


def shared():
    """The weights, vitta_tpu's variables and the source statistics of the
    checks' ``shared`` fixture."""
    mk = proj.MODELS[MODEL]
    torch.manual_seed(0)
    oracle = TorchRecognizer3D(proj.K, proj.PATCH, mk["embed_dim"],
                               mk["depths"], mk["num_heads"], proj.WINDOW)
    with torch.no_grad():
        for m in oracle.modules():
            if hasattr(m, "relative_position_bias_table"):
                m.relative_position_bias_table.normal_(0, 0.5)
    sd = {k: v.clone() for k, v in oracle.state_dict().items()}
    variables = convert_swin_checkpoint(sd, proj.K, depths=mk["depths"],
                                        window_size=proj.WINDOW)
    clean = np.random.default_rng(100).normal(
        size=(proj.V, proj.T, proj.HW, proj.HW, 3)).astype(np.float32)
    _, aux = JaxRecognizer3D(drop_path_rate=0.0, **proj._kw(MODEL)).apply(
        variables, jnp.asarray(clean), train=False, mutable=["taps"])
    src = {n: (np.asarray(s.mean), np.asarray(s.var))
           for n, s in jax_flatten_taps(aux["taps"]).items()}
    return dict(sd=sd, variables=variables, src=src)


def port_losses(s, route, v2):
    """[(loss_reg, loss_ce)] of the port's bfloat16 engine a step."""
    os.environ["VITTA_PATCHIFY_V2"] = "1" if v2 else "0"
    eng = VittaEngine(proj.Recognizer3D(drop_path_rate=0.0, head_dropout=0.0,
                                        dtype="bfloat16", attn_route=route,
                                        **proj._kw(MODEL)),
                      proj._cfg(swin_ucf101_preset, MODEL), s["sd"], s["src"],
                      device="cpu")
    state, out = eng.init_state(), []
    for views, clip, label in proj._videos():
        state, m = eng.adapt_eval_step(state, views, clip, label)
        out.append((float(m.loss_reg), float(m.loss_ce)))
    return out


def main():
    apart, n = embedding_roundings()
    print(f"patch embedding at bfloat16: {apart} of {n} outputs apart "
          "between the Conv3d and the product", flush=True)
    s = shared()
    _eng, metrics, _state = proj._jax_trajectory(s, MODEL, "bfloat16")
    ref = [(float(m.loss_reg), float(m.loss_ce)) for m in metrics]
    for route in ("proj", "ln_proj"):
        conv, prod = port_losses(s, route, False), port_losses(s, route, True)
        for i, (c, p, r) in enumerate(zip(conv, prod, ref)):
            rel = lambda a, b: abs(a - b) / abs(b)    # noqa: E731
            print(f"{route} step {i}: loss_ce rel conv-ref {rel(c[1], r[1]):.2e}"
                  f" product-ref {rel(p[1], r[1]):.2e} product-conv "
                  f"{rel(p[1], c[1]):.2e}; loss_reg rel conv-ref "
                  f"{rel(c[0], r[0]):.2e} product-ref {rel(p[0], r[0]):.2e} "
                  f"product-conv {rel(p[0], c[0]):.2e}", flush=True)


if __name__ == "__main__":
    main()
