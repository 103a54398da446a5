"""Per-site, per-launch device times of the LayerNorm backward and of the
bias collapse, on the card.

    python3 -m vitta_tpu_torch.tools.ln_bias_sites

At every LayerNorm site of a Video Swin-B and a Video Swin-T backward pass
of the adapt batch (2 clips of 16 x 224 x 224) it times one
``cuda_ln.ln_bwd_cuda`` call, and at every Swin-B and Swin-T stage one
``cuda_bias.collapse_bias_cuda`` call: each kernel's device time per
launch and its launches per call, from torch.profiler over ``REPS`` calls,
beside the call's bound (x, dy read and dx written; dB read and dV
written; over 3.35 TB/s) and the rate of the call's bytes over its device
time.  Two readings: back to back ("warm"; a call whose tensors fit in the
50 MB L2 then reads them from there) and with the L2 emptied of them
before each call ("cold"; a sum over 128 MB, which leaves no dirty line
behind, and whose own kernels are left out of the sums).  Ends with the sums over one Swin-B and one Swin-T pass.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
L2_BYTES = 50e6
REPS = 20
# every LayerNorm site of one forward pass: (tokens per clip, C) -> sites.
# Swin-B: patch-embed norm and stage-1 norm1, PatchMerging norms, norm1 of
# each block, final norm (norm2 is inside the LayerNorm-MLP op).  Swin-T
# (widths 96 and 192 run norm2 apart): patch-embed norm, norm1 and norm2 of
# stage 1; merging norm; norm1 and norm2 of stage 2; merging; stage-3
# norm1; merging; stage-4 norm1 and the final norm
SWIN_LN_SITES = {(25088, 128): 3, (6272, 256): 2, (6272, 512): 1,
                 (1568, 512): 18, (1568, 1024): 1, (392, 1024): 3,
                 (392, 2048): 1}
SWIN_T_LN_SITES = {(25088, 96): 5, (6272, 384): 1, (6272, 192): 4,
                   (1568, 768): 1, (1568, 384): 6, (392, 1536): 1,
                   (392, 768): 3}
# (heads, blocks) per stage: one collapse per block and backward pass
SWIN_B_BIAS = ((4, 2), (8, 2), (16, 18), (32, 2))
SWIN_T_BIAS = ((3, 2), (6, 2), (12, 6), (24, 2))
WINDOW = (8, 7, 7)


def per_launch(fn, flush=None, reps: int = REPS):
    """{kernel name: (device us a launch, launches a call)} of ``fn`` over
    ``reps`` calls, each after ``flush()`` where given; the flush's own
    kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(body):
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
        return {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0}

    skip = set(kernels(flush)) if flush is not None else set()
    both = (lambda: (flush(), fn())) if flush is not None else fn
    return {k: (us / n, n / reps) for k, (us, n) in kernels(both).items()
            if k not in skip}


def _short(name: str) -> str:
    """A profiler's kernel name without its return type, namespaces and
    arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].replace("vitta::", "")


def report(what, fn, nbytes, flush):
    """Print one site's line; returns (warm, cold, bound) us a call."""
    out = []
    for label, fl in (("warm", None), ("cold", flush)):
        k = per_launch(fn, fl)
        total = sum(us * n for us, n in k.values())
        parts = ", ".join(f"{_short(name)} {us:.2f} us x{n:g}"
                          for name, (us, n) in k.items())
        out.append((label, total, parts))
    bound_us = nbytes / HBM_BYTES_PER_S * 1e6
    l2 = "in L2 back to back" if nbytes < L2_BYTES else "not in L2"
    print(f"{what}: bound {bound_us:.2f} us ({nbytes / 1e6:.1f} MB, {l2}) | "
          + " | ".join(f"{label} {total:.2f} us, "
                       f"{nbytes / total / 1e3:.0f} GB/s, "
                       f"{bound_us / total:.2f} of the bound ({parts})"
                       for label, total, parts in out), flush=True)
    return out[0][1], out[1][1], bound_us


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    trash = torch.empty(32 * 2**20, device=dev)      # 128 MB

    trash.fill_(1.0)

    def flush():
        trash.sum()

    for model, sites in (("swin_b", SWIN_LN_SITES),
                         ("swin_t", SWIN_T_LN_SITES)):
        sums = [0.0, 0.0, 0.0]
        for (tokens, c), n in sites.items():
            rows = 2 * tokens
            x = torch.randn(rows, c, device=dev, generator=gen) * 2 + 0.5
            g = torch.randn(c, device=dev, generator=gen)
            dy = torch.randn(rows, c, device=dev, generator=gen)
            res = report(f"ln bwd {model} rows={rows} C={c} x{n}",
                         lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5),
                         3 * x.numel() * 4, flush)
            sums = [s + n * v for s, v in zip(sums, res)]
            del x, dy
        print(f"ln bwd per {model} pass: warm {sums[0] / 1e3:.4f} ms, cold "
              f"{sums[1] / 1e3:.4f} ms, bound {sums[2] / 1e3:.4f} ms",
              flush=True)
    wd, wh, ww = WINDOW
    n_tok = wd * wh * ww
    for model, stages in (("swin_b", SWIN_B_BIAS), ("swin_t", SWIN_T_BIAS)):
        sums = [0.0, 0.0, 0.0]
        for nh, n in stages:
            db = torch.randn(nh, n_tok, n_tok, device=dev, generator=gen)
            nbytes = (db.numel() + nh * (2 * wd - 1) * (wh * ww) ** 2) * 4
            res = report(f"bias collapse {model} nh={nh} x{n}",
                         lambda: cb.collapse_bias_cuda(db, wd), nbytes, flush)
            sums = [s + n * v for s, v in zip(sums, res)]
            del db
        print(f"bias collapse per {model} pass: warm {sums[0] / 1e3:.4f} ms,"
              f" cold {sums[1] / 1e3:.4f} ms, bound {sums[2] / 1e3:.4f} ms",
              flush=True)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
