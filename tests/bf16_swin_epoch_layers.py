"""Where the bfloat16 Swin epoch case's step-1 programs part: the port's
tapped forward of the adapt step against vitta_tpu's, layer by layer, from
the same weights (ROADMAP.md queue 3).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bf16_swin_epoch_layers.py \
        [--bias-apart] [--reference-attention]

The model, weights, source statistics and videos are those of
tests/test_torch_bf16_swin_modes.py's epoch case.  vitta_tpu's engine
(compiled with XLA's excess precision off, ``round_as_written``) takes
step 0; its float32 masters after it are loaded into the port's engine,
whose bfloat16 twin then holds vitta_tpu's ``params_half`` bit for bit.
Step 1's adapt forward (the normalised views, dropout and drop-path off)
then runs in three programs: vitta_tpu op by op (``jax.disable_jit``),
vitta_tpu compiled rounded as written, and the port; the outputs of every
module (flax's ``capture_intermediates``, torch forward hooks on the same
modules) are compared, in bfloat16 ulps of the reference and as the share
of elements that differ, then the chosen layers' taps, the logits, the
views' softmaxes that the consistency loss reads and the loss itself.
``--bias-apart`` runs the port with its bfloat16 patch embedding, qkv and
proj rounding the product before the bias, as vitta_tpu's ``nn.Conv`` /
``nn.Dense`` do (tests/bf16_swin_epoch_spread.py);
``--reference-attention`` its packed attention as vitta_tpu's CPU path
rounds it (``_reference_attention``).  Prints one JSON
object, the modules in the port's forward order.  About 1 min.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import test_torch_bf16_swin_engine as bse
from tests import test_torch_bf16_swin_modes as modes
from tests.torch_engine_modes import round_as_written
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu_torch.models.layers import Taps, flatten_taps
from vitta_tpu_torch.utils.checkpoint import swin_state_dict_from_jax


def _port_name(path):
    """vitta_tpu's module path -> the port's module name."""
    out = []
    for p in path:
        if p.startswith(("layers_", "blocks_")):
            out.extend(p.rsplit("_", 1))
        elif p == "patch_embed_proj":
            out.extend(["patch_embed", "proj"])
        elif p == "patch_embed_norm":
            out.extend(["patch_embed", "norm"])
        else:
            out.append(p)
    return ".".join(out)


def _reference_attention():
    """The port's Swin with its packed attention rounded as vitta_tpu's
    CPU path (``attention_reference``) rounds: q times the scale in
    bfloat16 before the product, the scale itself rounded to bfloat16 (a
    Python float meets a bfloat16 array there: JAX's weak type), the
    logits and softmax float32, the softmax rounded to bfloat16 before the
    product with v.  The port's own plain version rounds as the Pallas
    kernels do (the float32 scale applied to the float32 logits)."""
    from vitta_tpu_torch.models import swin

    def packed(qkv, bias, mask, scale, nh):
        b_, n, c3 = qkv.shape
        hd = c3 // (3 * nh)
        if bias.dim() == 4:
            bias = swin.expand_bias(bias, (bias.shape[1] + 1) // 2)
        q, k, v = qkv.reshape(b_, n, 3, nh, hd).unbind(2)
        q = q * torch.tensor(scale, dtype=q.dtype)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                            k.float()) + bias[None].float()
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, nh, n, n)
                    + mask[None, :, None].float()).reshape(b_, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", attn.float(),
                            v.float()).to(qkv.dtype).reshape(b_, n, c3 // 3)

    swin.window_attention_packed = packed


def _first_array(v):
    while isinstance(v, (tuple, list)):
        v = v[0]
    return v


def _compare(got, want):
    """(largest gap in bfloat16 ulps of ``want``, share of elements apart,
    largest absolute gap)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.abs(got - want)
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    return (float((gap / ulp).max()), float(np.mean(gap > 0)),
            float(gap.max()))


def main(argv):
    if "--bias-apart" in argv:
        from tests.bf16_swin_epoch_spread import _bias_apart
        _bias_apart()
    if "--reference-attention" in argv:
        _reference_attention()
    torch.set_num_threads(1)
    torch.manual_seed(0)
    weights = modes.weights.__wrapped__()
    sd, variables = weights
    src = {n: (np.asarray(s.mean), np.asarray(s.var)) for n, s in
           modes._source(variables, ("spatiotemp",), "stat").items()}
    jeng, eng = modes._engines(weights, src, as_written=True)
    data = bse._videos()
    views0, _clip, label0 = data[0]
    jstate = jeng.adapt_step(jeng.init_state(), jnp.asarray(views0),
                             jnp.asarray(label0), jax.random.PRNGKey(0))[0]
    # the port from vitta_tpu's state after step 0
    state = eng.init_state()
    masters = swin_state_dict_from_jax({"params": jstate.params},
                                       depths=bse.DEPTHS,
                                       window_size=bse.WINDOW)
    with torch.no_grad():
        for k, p in eng.model.named_parameters():
            p.copy_(masters[k])
    eng._refresh_twin()
    half = jeng._merge_half(jstate.params_half, jstate.params)

    views = data[1][0]
    xj = jeng._maybe_normalize(jnp.asarray(views))
    xp = eng._maybe_normalize(views)
    assert np.array_equal(np.asarray(xj), xp.numpy())

    def jax_forward(params, x):
        return jeng.model.apply(
            {"params": params, "batch_stats": jstate.batch_stats}, x,
            train=True, mutable=["taps", "intermediates"],
            capture_intermediates=True,
            rngs={"dropout": jax.random.PRNGKey(1)})

    with jax.disable_jit():
        op_logits, op_aux = jax_forward(half, xj)
    comp = jax.jit(jax_forward,
                   compiler_options={"xla_allow_excess_precision": False})
    as_logits, as_aux = comp(half, xj)

    captured = {}

    def keep(name, out):
        out = _first_array(out)
        if isinstance(out, torch.Tensor):
            captured.setdefault(name, out.detach().float().numpy())

    hooks = [m.register_forward_hook(
        lambda mod, _a, out, name=name: keep(name, out))
        for name, m in eng.model.named_modules() if name]
    # vitta_tpu normalises a block's tokens in windows: its norm1 output
    # is the port's attention input
    windowed = {}

    def keep_input(name, a):
        windowed[name[:-len("attn")] + "norm1"] = \
            a[0].detach().float().numpy()

    hooks += [m.register_forward_pre_hook(
        lambda mod, a, name=name: keep_input(name, a))
        for name, m in eng.model.named_modules() if name.endswith(".attn")]
    taps = Taps(eng._tap_leaves, eng._tap_layers)
    with torch.no_grad():
        logits = eng.model(xp, taps, train=True, generator=eng.generator)
    for h in hooks:
        h.remove()
    captured.update(windowed)

    def flat(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, path + (k,))
            elif k == "__call__":
                yield path, _first_array(v)

    modules = []
    op_mods = dict(flat(op_aux["intermediates"]))
    as_mods = {_port_name(path): (path, want) for path, want
               in flat(as_aux["intermediates"]) if path}
    # the modules whose outputs have one layout in both programs, in the
    # port's forward order (vitta_tpu keeps a stage's tokens in windows
    # between its blocks; the attention's output is in windows in both)
    for name in captured:
        path, want = as_mods.get(name, (None, None))
        if path is None or np.shape(captured[name]) != np.shape(want):
            continue
        modules.append({
            "module": name,
            "port_vs_as_written": _compare(captured[name], want),
            "op_by_op_vs_as_written": _compare(op_mods[path], want),
            "dtype": str(np.asarray(want).dtype)})
    tap_cmp = {}
    jtaps = jax_flatten_taps(as_aux["taps"], eng.reg_specs[0].leaf)
    ptaps = flatten_taps(taps, eng.reg_specs[0].leaf)
    for n in eng.tap_names:
        tap_cmp[n] = [_compare(ptaps[n].mean.numpy(), jtaps[n].mean),
                      _compare(ptaps[n].var.numpy(), jtaps[n].var)]

    def softmax(z):
        z = np.asarray(z, np.float64).reshape(-1, bse.V, bse.K)
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    from vitta_tpu.ops.losses import pred_consistency as jax_consis
    from vitta_tpu_torch.ops.losses import pred_consistency
    consis = {
        "port": float(pred_consistency(logits.reshape(-1, bse.V, bse.K))),
        "as_written": float(jax_consis(as_logits.reshape(-1, bse.V, bse.K))),
        "op_by_op": float(jax_consis(op_logits.reshape(-1, bse.V, bse.K)))}
    out = {
        "modules": modules, "taps": tap_cmp,
        "logits": {"port_vs_as_written": _compare(logits.numpy(), as_logits),
                   "op_by_op_vs_as_written": _compare(op_logits, as_logits)},
        "softmax": {"port_vs_as_written": _compare(softmax(logits.numpy()),
                                                   softmax(as_logits)),
                    "op_by_op_vs_as_written": _compare(softmax(op_logits),
                                                       softmax(as_logits))},
        "consistency_loss": consis}
    first = next((m["module"] for m in modules
                  if m["port_vs_as_written"][1] > 0), None)
    out["first_module_apart"] = first
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv)
