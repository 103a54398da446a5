"""How far the batch-statistics BN mode (``fix_BNS=False``) of a TANet
adapt step can be held against the JAX engine, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/bns_conditioning.py \
        [frames] [clip length] [steps] [lr] [drawn|clean] [output|input]

Builds the seeded TANet of tests/test_torch_engine.py (random weights,
running statistics drawn by ``randomize_bn_stats`` or, with ``clean``, set
to the batch statistics of a seeded clean clip), runs ``steps`` adapt+eval
steps of the port's engine and of ``vitta_tpu``'s from the same weights,
source statistics (output- or input-side, ``before_norm``) and videos, and
prints per step the three losses of both, then per parameter tensor the
update's gap |port - JAX| / |JAX| (median, worst, how many over 2%).  It
also runs the port against itself with every weight moved by one float32
ulp (2^-23 of it, random sign), the same steps: the gap that the mode's
conditioning alone leaves between two float32 implementations.
ROADMAP.md (queue 3) keeps what it printed.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tests.test_torch_engine as te
from tests.torch_tanet import TorchTSN, randomize_bn_stats
from vitta_tpu.adapt.engine import VittaEngine as JaxEngine
from vitta_tpu.adapt.engine import flatten_taps as jax_flatten_taps
from vitta_tpu.config import tanet_ucf101_preset as jax_preset
from vitta_tpu.models.layers import tap_leaf_name
from vitta_tpu.models.tanet import TANet as JaxTANet
from vitta_tpu.utils.checkpoint import convert_tanet_checkpoint
from vitta_tpu_torch.utils.checkpoint import tanet_state_dict_from_jax


def weights(hw, clean):
    torch.manual_seed(0)
    oracle = TorchTSN(te.K, te.T)
    if clean:
        frames = np.random.default_rng(100).normal(
            size=(te.V, te.T, hw, hw, 3)).astype(np.float32)
        for m in oracle.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.momentum = None
                m.reset_running_stats()
        oracle.train()
        with torch.no_grad():
            oracle(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
        oracle.eval()
    else:
        with torch.no_grad():
            randomize_bn_stats(oracle)
    return oracle.state_dict()


def source(variables, hw, input_side):
    clean = np.random.default_rng(100).normal(size=(te.V, te.T, hw, hw, 3))
    _, aux = JaxTANet(num_classes=te.K, clip_length=te.T).apply(
        variables, jnp.asarray(clean, jnp.float32), train=False,
        mutable=["taps"])
    leaf = tap_leaf_name("spatiotemp", input_side)
    return {n: (np.asarray(s.mean), np.asarray(s.var))
            for n, s in jax_flatten_taps(aux["taps"], leaf).items()
            if "g_bn" not in n and "l_bn" not in n}


def gaps(got, want, init_got, init_want):
    out = []
    for k, w in want.items():
        if "running" in k or "num_batches" in k:
            continue
        dj = w.numpy() - init_want[k].numpy()
        dp = got[k].numpy() - init_got[k].numpy()
        n = np.linalg.norm(dj)
        if n > 0:
            out.append((float(np.linalg.norm(dp - dj) / n), k))
    out.sort(reverse=True)
    r = [g for g, _k in out]
    return (f"median {np.median(r):.4f}, worst {out[0][0]:.4f} ({out[0][1]}),"
            f" {sum(g > 0.02 for g in r)} of {len(r)} over 2%")


def main(argv):
    hw, te.T, steps = int(argv[1]), int(argv[2]), int(argv[3])
    lr, clean, input_side = float(argv[4]), argv[5] == "clean", \
        argv[6] == "input"
    sd = weights(hw, clean)
    variables = convert_tanet_checkpoint(sd, te.K)
    src = source(variables, hw, input_side)
    tta = dict(fix_BNS=False, before_norm=input_side)
    jeng = JaxEngine(JaxTANet(num_classes=te.K, clip_length=te.T,
                              dropout=0.0), te._cfg(jax_preset, lr=lr, **tta),
                     variables, src, donate=False)
    eng = te._port_engine((sd, variables, src), lr=lr, **tta)
    gen = torch.Generator().manual_seed(1)
    moved = {k: v * (1 + (torch.randint(0, 2, v.shape, generator=gen) * 2 - 1)
                     * 2.0 ** -23)
             if v.is_floating_point() and "running" not in k else v.clone()
             for k, v in sd.items()}
    twin = te._port_engine((moved, variables, src), lr=lr, **tta)
    js, s, ts = jeng.init_state(), eng.init_state(), twin.init_state()
    key = jax.random.PRNGKey(0)
    for i, (views, clip, label) in enumerate(te._videos(steps, hw)):
        js, jm = jeng.adapt_eval_step(js, jnp.asarray(views),
                                      jnp.asarray(clip), jnp.asarray(label),
                                      jax.random.fold_in(key, i))
        s, m = eng.adapt_eval_step(s, views, clip, label)
        ts, _tm = twin.adapt_eval_step(ts, views, clip, label)
        print(f"step {i}: " + ", ".join(
            f"{f} port {float(getattr(m, f)):.6g} jax "
            f"{float(getattr(jm, f)):.6g}"
            for f in ("loss_reg", "loss_consis", "loss_ce")), flush=True)
    want = tanet_state_dict_from_jax({"params": js.params,
                                      "batch_stats": js.batch_stats})
    print(f"frames {hw}, T {te.T}, {steps} steps, lr {lr}, running "
          f"statistics {'clean' if clean else 'drawn'}, "
          f"{'input' if input_side else 'output'}-side statistics")
    print("updates, port against JAX:",
          gaps(eng.model.state_dict(), want, sd, sd))
    print("updates, port against itself one ulp away:",
          gaps(twin.model.state_dict(), eng.model.state_dict(), moved, sd))


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(sys.argv)
