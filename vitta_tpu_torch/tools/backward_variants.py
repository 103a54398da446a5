"""Time the attention backward kernel at other shapes, on the card.

    python3 -m vitta_tpu_torch.tools.backward_variants

``csrc/attention_kernels.cuh`` fixes the backward kernel's shape with three
macros: query rows per strip (``VITTA_ATTN_BWD_STRIP``, 16), keys per warp
(``VITTA_ATTN_BWD_KEYS``, 32) and the most blocks that share a problem
(``VITTA_ATTN_BWD_SPLIT``, 4).  This script
builds ``csrc/attention.cu`` once per entry of ``VARIANTS`` with
``nvcc -Xptxas -v``, prints the kernel's registers and spills, checks every
build against the plain backward version, and prints the CUDA-event time of
one backward call (two or three launches) at the four Swin-B stage shapes
for 2 clips and the last stage for 1 clip, beside the forward's and
``scaled_dot_product_attention``'s backward (dq, dk, dv only).  A variant
that does not build, or does not launch (more shared memory than a block
may have), is reported and left out.  It also prints the event
time of one LayerNorm-MLP backward call per stage.  Needs a CUDA device and
nvcc; the libraries go to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch
import torch.nn.functional as F

from vitta_tpu_torch.ops import _build
from vitta_tpu_torch.ops import cuda_attention as ca
from vitta_tpu_torch.ops import cuda_bias as cb
from vitta_tpu_torch.ops import cuda_mlp as cm

# name -> macro values; the first is the source's own
VARIANTS = {
    "strip 16, keys 32, split 4": {},
    "split 1": {"VITTA_ATTN_BWD_SPLIT": 1},
    "split 2": {"VITTA_ATTN_BWD_SPLIT": 2},
    "strip 32": {"VITTA_ATTN_BWD_STRIP": 32},
    "keys 16": {"VITTA_ATTN_BWD_KEYS": 16},
}
# Swin-B stages on 16x224x224 clips: width, heads, windows, mask windows
# (0: no mask); the last stage also for 1 clip
STAGES = ((128, 4, 128, 64), (256, 8, 32, 16), (512, 16, 8, 4),
          (1024, 32, 2, 0), (1024, 32, 1, 0))
WD, HW = 8, 49
TOL = 2e-5     # of the largest value, as chip_smoke.py's ATTN_BWD_TOL


def build_variant(tag: int, macros: dict):
    """The variant's library, or None where nvcc refuses it."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libattention_{tag}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           *(f"-D{k}={v}" for k, v in macros.items()),
           "-o", str(out), str(_build.CSRC_DIR / "attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"  {macros}: nvcc failed:\n{proc.stderr[-2000:]}", flush=True)
        return None
    lines = proc.stderr.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "attn_bwd_kernel" in line:
            info = " ".join(lines[k + 1:k + 3]).replace("ptxas info    :", "")
            print(f"  {macros or 'as the source'}:{info}", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vitta_attn_packed_bwd.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float,
                                                             p]
    lib.vitta_attn_packed_bwd.restype = i
    lib.vitta_attn_bwd_scratch_floats.argtypes = [i] * 4
    lib.vitta_attn_bwd_scratch_floats.restype = ctypes.c_longlong
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
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    libs = {}
    for tag, (name, macros) in enumerate(VARIANTS.items()):
        lib = build_variant(tag, macros)
        if lib is not None:
            libs[name] = lib
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
        q5 = qkv.reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        leaves = [q5[i].detach().requires_grad_() for i in range(3)]
        am = dense[None] if mask is None else (
            dense[None, None] + mask[None, :, None]).expand(
                b_ // nw, nw, nh, n, n).reshape(b_, nh, n, n)
        with torch.enable_grad():
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=am,
                                                   scale=scale)
        g4 = g.reshape(b_, n, nh, hd).permute(0, 2, 1, 3)
        sdpa = event_ms(lambda: torch.autograd.grad(o_lib, leaves, g4,
                                                    retain_graph=True))
        print(f"attention B_={b_} nh={nh} N={n} mask={nw > 0}: forward "
              f"{fwd:.3f} ms, sdpa backward {sdpa:.3f} ms; backward by "
              "variant:", flush=True)
        dqkv, dbias = torch.empty_like(qkv), torch.empty_like(dense)
        for name, lib in libs.items():
            scratch = torch.empty(
                lib.vitta_attn_bwd_scratch_floats(b_, n, nh, hd), device=dev)

            def run():
                return lib.vitta_attn_packed_bwd(
                    qkv.data_ptr(), dense.data_ptr(),
                    None if mask is None else mask.data_ptr(), ms.data_ptr(),
                    g.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
                    scratch.data_ptr(), b_, n, nh, hd, nw, 0, WD, HW, scale,
                    stream)
            code = run()
            if code != 0:
                print(f"  {name}: does not launch (CUDA error {code})",
                      flush=True)
                continue
            t = event_ms(run)
            errs = []
            for what, got, ref in (("dqkv", dqkv, want[0]),
                                   ("dbias", dbias, want[1])):
                err = float((got - ref).abs().max())
                if not err <= TOL * float(ref.abs().max()):
                    raise AssertionError(f"{name} {what}: error {err:.3e}")
                errs.append(err / float(ref.abs().max()))
            print(f"  {name}: {t:.3f} ms (error {max(errs):.2e} of the "
                  "largest value)", flush=True)
            del scratch
        del qkv, g, want, dqkv, dbias, leaves, o_lib, am

    for c, _nh, b_, _nw in STAGES[:4]:
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
