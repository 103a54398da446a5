"""Time the TAM backward at other shapes of its work, and in turns with
another checkout's, on the card.

    python3 -m vitta_tpu_torch.tools.tam_variants [--bf16] [--parent DIR ...] [rounds]

Float32 (the default): ``csrc/tam.cu`` fixes the choices of its float32
backward as constants: the frames whose loads a thread issues together
(``kDepth``, 4), the most units of a position (4 channels, or 1) a block
spans (``kMaxUnits``, 16), the blocks the grid aims at (``kTargetBlocks``,
132) and the blocks an SM must hold, which caps the registers
(``kMinBlocks``, 2); ``VARIANTS`` changes them.  ``--bf16``: those of the
bfloat16 backward in 16-byte units (tam_bwd_bf16x8_kernel, one launch):
the frames of a segment (``kB16Frames``, 4), the most units of 8 channels
a block spans (``kB16MaxUnits``, 4), the blocks an SM the grid aims at and
the registers allow (``kB16BlocksPerSm``, 2) and the partial rows the last
blocks load at once (``kB16SumAhead``, 8), the runs a block's
slots are added in (``kB16SlotParts``, 8); ``BF16_VARIANTS`` changes
them.
The script writes a copy of ``csrc/tam.cu`` for each entry with those
constants changed and, with ``--parent``, takes each ``DIR``'s own
``vitta_tpu_torch/csrc/tam.cu`` (an unpacked ``git archive`` of another
commit under ``build/``; its C interface is bound as it stands: the
bfloat16 entry without a slot of tickets, and with units of 4 channels,
where it has no slot).  It builds them all at once with ``nvcc -Xptxas
-v`` and prints each backward kernel's registers and spills.  At every
ResNet-50 TAM site of the adapt batch (n=2, t=16) it checks every build
against the plain version (``tam_dynamic_conv_backward_reference``: dx its
bits at bfloat16 and within ``GRAD_TOL`` at float32, dattn and dkernel
within ``GRAD_TOL``) and that two runs give the same bits; then it times
one backward call of each build, in turns over the rounds (default
``ROUNDS``): device ms from torch.profiler (every launch of the call) and
ms a call of a CUDA graph's replay (the kernels back to back, the gaps
between them included), and prints per site the medians beside the bound
(bytes over 3.35 TB/s) and per adapt pass (the 16 sites) the median, least
and most of the rounds' sums.  Needs a CUDA device and nvcc; the copies and
their libraries go to ``build/vitta_tpu_torch/variants/``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from vitta_tpu_torch.ops import _build, cuda_tam
from vitta_tpu_torch.tools.ln_variants import device_ms, graph_ms

# name -> constants of csrc/tam.cu changed; the first is the source's own
VARIANTS = {
    "as the source": {},
    "wc 32": {"kMaxUnits": 32},
    "wc 8": {"kMaxUnits": 8},
    "target 264": {"kTargetBlocks": 264},
    "depth 2": {"kDepth": 2},
    "depth 8": {"kDepth": 8},
    "minb 3": {"kMinBlocks": 3},
}
BF16_VARIANTS = {
    "as the source": {},
    "wc 8": {"kB16MaxUnits": 8},
    "slots in 1 run": {"kB16SlotParts": 1},
    "slots in 16 runs": {"kB16SlotParts": 16},
    "sum ahead 16": {"kB16SumAhead": 16},
}
# ResNet-50's TAM sites, (H, W, C) -> sites per pass (chip_smoke.TAM_SITES)
SITES = {(56, 56, 64): 3, (56, 56, 128): 1, (28, 28, 128): 3,
         (28, 28, 256): 1, (14, 14, 256): 5, (14, 14, 512): 1,
         (7, 7, 512): 2}
GRAD_TOL = 2e-4
ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12


def patched_source(consts: dict) -> str:
    """csrc/tam.cu with the given ``constexpr int`` constants changed."""
    src = (_build.CSRC_DIR / "tam.cu").read_text()
    for name, value in consts.items():
        src, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                            rf"\g<1>{value};", src)
        if hits != 1:
            raise SystemExit(f"tam.cu holds no one constant {name}")
    return src


def build(name: str, src: Path, include: Path, out: Path):
    """(name, library or None, ptxas's lines on the backward kernels)."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(include), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        return name, None, [f"nvcc failed:\n{proc.stderr[-2000:]}"]
    lines, info = proc.stderr.splitlines(), []
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "tam_bwd" in line:
            kernel = line.split("'")[1]
            kernel = kernel[kernel.index("tam_bwd"):][:48]
            info.append(kernel + ": " + " ".join(
                x.replace("ptxas info    :", "").strip()
                for x in lines[k + 1:k + 4]
                if "spill" in x or "registers" in x))
    return name, ctypes.CDLL(str(out)), info


class Build:
    """One library's backward by its own C interface."""

    def __init__(self, name: str, lib):
        self.name, self.lib = name, lib
        p, i = ctypes.c_void_p, ctypes.c_int
        self.slotted = hasattr(lib, "vitta_tam_slots")
        lib.vitta_tam_bwd.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.vitta_tam_bwd.restype = i
        lib.vitta_tam_bwd_bf16.argtypes = [p] * 8 + [i] * (
            6 if self.slotted else 5) + [p]
        lib.vitta_tam_bwd_bf16.restype = i
        lib.vitta_tam_bwd_scratch_floats.argtypes = [i] * 5
        lib.vitta_tam_bwd_scratch_floats.restype = ctypes.c_longlong
        if self.slotted:
            lib.vitta_tam_bwd_bf16_scratch_floats.argtypes = [i] * 5
            lib.vitta_tam_bwd_bf16_scratch_floats.restype = ctypes.c_longlong

    def call(self, g, x, a, k):
        """A function of no argument that runs one backward call into
        outputs made here; and the outputs (dx, dattn, dkernel)."""
        n, t, h, w, c = x.shape
        p, lib = h * w, self.lib
        outs = [torch.empty_like(v) for v in (x, a, k)]
        extra = ()
        if x.dtype == torch.float32:
            vec = cuda_tam.bwd_vec(c, g, x, a, outs[0])
            floats = lib.vitta_tam_bwd_scratch_floats(n, t, p, c, vec)
            entry = lib.vitta_tam_bwd
        elif self.slotted:
            vec = cuda_tam.bwd_vec(c, g, x, a, outs[0])
            floats = lib.vitta_tam_bwd_bf16_scratch_floats(n, t, p, c, vec)
            entry, extra = lib.vitta_tam_bwd_bf16, (0,)   # slot 0
        else:                 # units of 4 channels, 8 bytes at bfloat16
            vec = int(c % 4 == 0)
            floats = lib.vitta_tam_bwd_scratch_floats(n, t, p, c, vec)
            entry = lib.vitta_tam_bwd_bf16
        scratch = torch.empty(floats, device=x.device)

        def run():
            code = entry(g.data_ptr(), x.data_ptr(), a.data_ptr(),
                         k.data_ptr(), outs[0].data_ptr(), scratch.data_ptr(),
                         outs[1].data_ptr(), outs[2].data_ptr(), n, t, p, c,
                         vec, *extra, torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"{self.name}: CUDA error {code}")
        return run, outs


def main(rounds: int = ROUNDS, parents=(), bf16: bool = False) -> int:
    if not torch.cuda.is_available():
        print("tam_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if bf16 else torch.float32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {card}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TAM backward at {str(dtype)[6:]}",
          flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tag, (name, consts) in enumerate(
            (BF16_VARIANTS if bf16 else VARIANTS).items()):
        src = out_dir / f"tam_{'b' if bf16 else 'f'}{tag}.cu"
        src.write_text(patched_source(consts))
        jobs.append((name, src, _build.CSRC_DIR,
                     out_dir / f"libtam_{'b' if bf16 else 'f'}{tag}.so"))
    for k, d in enumerate(parents):
        csrc = Path(d).resolve() / "vitta_tpu_torch" / "csrc"
        jobs.append((f"parent {Path(d).name}", csrc / "tam.cu", csrc,
                     out_dir / f"libtam_parent_{k}.so"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    builds = {}
    for name, lib, info in built:
        print(f"{name}:", flush=True)
        for line in info:
            print(f"  {line}", flush=True)
        if lib is not None:
            builds[name] = Build(name, lib)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(builds)
    step = {name: [[0.0] * rounds for _ in range(2)] for name in builds}
    bound_step = 0.0
    for (h, w, c), sites in SITES.items():
        n, t = 2, 16
        x = torch.randn(n, t, h, w, c, device=dev, generator=gen).to(dtype)
        g = torch.randn(n, t, h, w, c, device=dev, generator=gen).to(dtype)
        a = torch.sigmoid(torch.randn(n, t, c, device=dev, generator=gen))
        k = torch.softmax(torch.randn(n, c, 3, device=dev, generator=gen), -1)
        want = cuda_tam.tam_dynamic_conv_backward_reference(g, x, a, k)
        runs = {}
        for name, b in builds.items():
            run, outs = b.call(g, x, a, k)
            run()
            first = [o.clone() for o in outs]
            run()
            torch.cuda.synchronize()
            if not all(torch.equal(o, f) for o, f in zip(outs, first)):
                raise AssertionError(f"{name} {(h, w, c)}: two runs differ")
            if dtype == torch.bfloat16 and not torch.equal(outs[0], want[0]):
                raise AssertionError(f"{name} {(h, w, c)}: dx is not the "
                                     "plain version's")
            for what, o, ref in zip(("dx", "dattn", "dkernel"), outs, want):
                torch.testing.assert_close(o.float(), ref.float(),
                                           rtol=GRAD_TOL, atol=GRAD_TOL,
                                           msg=f"{name} {what}")
            runs[name] = run
        times = {name: ([], []) for name in builds}
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name][0].append(device_ms(runs[name]))
                times[name][1].append(graph_ms(runs[name]))
        small = (a.numel() + k.numel()) * 4
        bound = ((3 * x.numel() * x.element_size() + 2 * small)
                 / HBM_BYTES_PER_S * 1e3)
        bound_step += sites * bound
        print(f"tam bwd n={n} t={t} {h}x{w}x{c} ({sites} sites): device / "
              f"graph us a call, medians over {rounds} rounds; bound "
              f"{bound * 1e3:.2f} us by bytes", flush=True)
        for name in builds:
            med = [statistics.median(v) for v in times[name]]
            print(f"  {name}: {med[0] * 1e3:.2f} / {med[1] * 1e3:.2f} "
                  f"(graph {bound / med[1]:.2f} of the bound)", flush=True)
            for j in range(2):
                for r in range(rounds):
                    step[name][j][r] += sites * times[name][j][r]
        del x, g, a, k, want, runs
    print(f"tam bwd {str(dtype)[6:]} per adapt pass (16 sites, bound "
          f"{bound_step:.4f} ms by bytes): device / graph ms, median [least, "
          f"most] of {rounds} rounds; on {card}:", flush=True)
    for name in builds:
        print(f"  {name}: " + " / ".join(
            f"{statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
            for v in step[name]), flush=True)
    return 0


if __name__ == "__main__":
    args, dirs = sys.argv[1:], []
    while "--parent" in args:
        at = args.index("--parent")
        dirs.append(args[at + 1])
        del args[at:at + 2]
    wide = "--bf16" in args
    args = [a for a in args if a != "--bf16"]
    sys.exit(main(*(int(a) for a in args), parents=dirs, bf16=wide))
