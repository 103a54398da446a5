"""How far the trainer's batch-statistics step can be held against
vitta_tpu's, on the CPU, and how far two planted faults read.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/trainer_conditioning.py \
        [size ...]

For each ``size`` (default 64) runs vitta_tpu's ``Trainer`` over the three
batches of 4 clips at T 2, ``size`` x ``size`` of tests/test_torch_train.py
(clipping at 0.5, the learning rate dropping x0.1 after every step), and
from its state before each step the port's step: sound, with every weight
moved by one float32 ulp (seeds 1-3), without weight decay, and with the
TAM backward's kernel gradient reversed.  Prints per step the gap of the
whole update and of the whole momentum buffer, relative to their norms:
the sound port against vitta_tpu, and each other run against the sound
port.  The bound of tests/test_torch_train.py is SPREAD_FACTOR times the
larger spread of seeds 1 and 2, at most 10%.  ROADMAP.md (queue 3) keeps
what it printed.
"""

import sys

import torch

import tests.test_torch_train as tt
from vitta_tpu_torch.adapt.train import Trainer
from vitta_tpu_torch.models.tanet import TANet
from vitta_tpu_torch.ops import cuda_tam


def main(sizes):
    torch.set_num_threads(4)
    clip = 0.5
    backward = cuda_tam.TamPlain.backward

    def reversed_dkernel(ctx, g):
        dx, dattn, dkernel = backward(ctx, g)
        return dx, dattn, dkernel.flip(-1)

    for hw in sizes:
        snaps, _metrics = tt._vitta_tpu_steps(clip, hw)
        for k in range(tt.STEPS):
            start, mom = snaps[k]
            sound = tt._port_step(tt._port_trainer(clip), k, start, mom, hw)
            row = {"vitta_tpu": tt._gaps(sound, start, snaps[k + 1], start)}
            for seed in (1, 2, 3):
                away = tt._one_ulp_away(start, seed)
                run = tt._port_step(tt._port_trainer(clip), k, away, mom, hw)
                row[f"one ulp {seed}"] = tt._gaps(run, away, sound, start)
            no_wd = Trainer(TANet(tt.K, clip_length=tt.T, dropout=0.0),
                            clip_gradient=clip, weight_decay=0.0,
                            device="cpu", **tt.SCHEDULE)
            row["no weight decay"] = tt._gaps(
                tt._port_step(no_wd, k, start, mom, hw), start, sound, start)
            cuda_tam.TamPlain.backward = staticmethod(reversed_dkernel)
            try:
                run = tt._port_step(tt._port_trainer(clip), k, start, mom, hw)
            finally:
                cuda_tam.TamPlain.backward = staticmethod(backward)
            row["TAM kernel gradient reversed"] = tt._gaps(run, start, sound,
                                                           start)
            print(f"{hw} x {hw} step {k} (update, momentum): " + "; ".join(
                f"{name} {u:.4f} / {m:.4f}" for name, (u, m) in row.items()),
                flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64])
