"""Time the attention backward kernels at other block shapes, on the card.

    python3 -m vitta_tpu_torch.tools.backward_variants

``csrc/attention.cu`` fixes the query and key kernels' rows per warp pass
and warps per block with two macros (2 and 16).  This script builds the
source once per shape in ``VARIANTS`` with ``nvcc -Xptxas -v``, prints each
backward kernel's registers and spills, checks every build against the
plain backward version, and prints the CUDA-event time of one backward
call (three launches) at the four Swin-B stage shapes for 2 clips, beside
the forward's.  It also prints the event time of one LayerNorm-MLP
backward call per stage.  Needs a CUDA device and nvcc; the libraries go
to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from vitta_tpu_torch.ops import _build
from vitta_tpu_torch.ops import cuda_attention as ca
from vitta_tpu_torch.ops import cuda_bias as cb
from vitta_tpu_torch.ops import cuda_mlp as cm

VARIANTS = ((2, 16), (4, 12), (4, 16), (4, 8), (2, 8))   # (rows, warps)
# Swin-B stages for 2 clips of 16x224x224: width, heads, windows, mask
# windows (0: no mask)
STAGES = ((128, 4, 128, 64), (256, 8, 32, 16), (512, 16, 8, 4),
          (1024, 32, 2, 0))
WD, HW = 8, 49
TOL = 2e-5     # of the largest value, as chip_smoke.py's ATTN_BWD_TOL


def build_variant(rows: int, warps: int) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libattention_{rows}x{warps}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           f"-DVITTA_ATTN_BWD_ROWS={rows}", f"-DVITTA_ATTN_BWD_WARPS={warps}",
           "-o", str(out), str(_build.CSRC_DIR / "attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {rows} x {warps}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "attn_bwd" in line:
            name = "query" if "bwd_q" in line else "key"
            info = " ".join(lines[k + 1:k + 3]).replace("ptxas info    :", "")
            print(f"  {rows} x {warps} {name} kernel:{info}", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vitta_attn_packed_bwd.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float,
                                                             p]
    lib.vitta_attn_packed_bwd.restype = i
    return lib


def event_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("backward_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}", flush=True)
    libs = {v: build_variant(*v) for v in VARIANTS}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    n = WD * HW
    stream = torch.cuda.current_stream().cuda_stream
    for c, nh, b_, nw in STAGES:
        hd = c // nh
        scale = hd ** -0.5
        qkv, g = randn(b_, n, 3 * c), randn(b_, n, c)
        dense = cb.expand_bias_reference(randn(nh, 2 * WD - 1, HW, HW), WD)
        mask = None
        if nw:
            mask = torch.where(
                torch.rand(nw, n, n, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        _out, ms = ca.attn_packed_fwd_cuda(qkv, dense, mask, scale, nh, True)
        want = ca.packed_attention_backward_reference(qkv, dense, mask, ms, g,
                                                      scale, nh)
        fwd = event_ms(lambda: ca.attn_packed_fwd_cuda(qkv, dense, mask,
                                                       scale, nh, True))
        print(f"attention B_={b_} nh={nh} N={n} mask={nw > 0}: forward "
              f"{fwd:.3f} ms; backward by rows x warps:", flush=True)
        dqkv, dbias = torch.empty_like(qkv), torch.empty_like(dense)
        scratch = torch.empty(b_ * nh * n * (n + 1), device=dev)
        for (rows, warps), lib in libs.items():
            def run():
                code = lib.vitta_attn_packed_bwd(
                    qkv.data_ptr(), dense.data_ptr(),
                    None if mask is None else mask.data_ptr(), ms.data_ptr(),
                    g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
                    scratch.data_ptr(), b_, n, nh, hd, nw, 0, WD, HW, scale,
                    stream)
                if code != 0:
                    raise RuntimeError(f"launch failed: CUDA error {code}")
            t = event_ms(run)
            for name, got, ref in (("dqkv", dqkv, want[0]),
                                   ("dbias", dbias, want[1])):
                err = float((got - ref).abs().max())
                if not err <= TOL * float(ref.abs().max()):
                    raise AssertionError(f"{rows} x {warps} {name}: error "
                                         f"{err:.3e}")
            print(f"  {rows} x {warps}: {t:.3f} ms", flush=True)
        del qkv, g, want, dqkv, dbias, scratch

    for c, _nh, b_, _nw in STAGES:
        m, f = b_ * n, 4 * c
        x = randn(m, c, scale=1.5)
        gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
        w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
        _o, y, a, s = cm.ln_mlp_fwd_cuda(x, gm, bt, w1, b1, w2, b2, 1e-5, True)
        go, gy = randn(m, c), randn(m, c)
        t = event_ms(lambda: cm.ln_mlp_bwd_cuda(x, y, a, s, go, gy, gm, w1,
                                                w2, 1e-5))
        print(f"ln_mlp backward M={m} C={c}: {t:.3f} ms per call", flush=True)
        del x, y, a, s, go, gy
    return 0


if __name__ == "__main__":
    sys.exit(main())
