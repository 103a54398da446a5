"""The port stands alone: importing all of vitta_tpu_torch loads neither
JAX (nor flax or optax) nor the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import vitta_tpu_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        vitta_tpu_torch.__path__, "vitta_tpu_torch."))
    for name in ("adapt.loops", "adapt.precompute", "models.swin",
                 "ops.cuda_ln", "ops.cuda_bias", "ops.cuda_attention",
                 "ops.cuda_mlp", "ops.cuda_attention_proj", "ops.dispatch",
                 "tools.attention_routes", "tools.synthetic"):
        assert f"vitta_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vitta_tpu'))\n"
        "print(len(bad))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0"
