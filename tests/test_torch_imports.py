"""The port stands alone: importing all of vitta_tpu_torch loads neither
JAX (nor flax or optax) nor the JAX package; importing its data layer
loads neither PIL nor decord and builds nothing."""

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
                 "ops.cuda_stats", "ops.relation",
                 "tools.attention_routes", "tools.synthetic",
                 "data.records", "data.sampling", "data.native",
                 "data.transforms", "data.video_reader", "data.native_decode",
                 "data.dataset", "data.pipeline"):
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


def test_mlp_and_heads_names_import_without_jax():
    """The MLP without the LayerNorm, the attention per (head, window), the
    fourth route and the MLP rule, from a process that never saw JAX."""
    code = (
        "import sys\n"
        "from vitta_tpu_torch.ops.cuda_mlp import mlp, mlp_reference, "
        "mlp_backward_reference\n"
        "from vitta_tpu_torch.ops.cuda_attention import "
        "window_attention_heads, heads_attention_backward_reference\n"
        "from vitta_tpu_torch.ops.dispatch import ATTN_ROUTES, mlp_ln_fused\n"
        "from vitta_tpu_torch.models import swin\n"
        "assert ATTN_ROUTES == ('packed', 'proj', 'ln_proj', 'heads')\n"
        "assert swin.mlp is mlp and swin.mlp_ln_fused is mlp_ln_fused\n"
        "assert swin.window_attention_heads is window_attention_heads\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vitta_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_stats_op_and_engine_modes_import_without_jax():
    """The BatchNorm-statistics op, the relation maps, and the engine's
    other modes' entry points, from a process that never saw JAX."""
    code = (
        "import sys\n"
        "from vitta_tpu_torch.ops.cuda_stats import fused_bn_relu_stats, "
        "fused_bn_relu_stats_reference, "
        "fused_bn_relu_stats_backward_reference, counters\n"
        "from vitta_tpu_torch.ops.relation import pairwise_similarity, "
        "upper_triangle_idx, cossim_regularization\n"
        "from vitta_tpu_torch.adapt.loops import tta_epoch_adapt\n"
        "from vitta_tpu_torch.adapt.precompute import "
        "compute_cossim_statistics\n"
        "from vitta_tpu_torch.adapt.optim import norm_affine_mask\n"
        "from vitta_tpu_torch.adapt.engine import batch_stats_as_tapdict\n"
        "from vitta_tpu_torch.utils.checkpoint import save_cossim, "
        "load_reference_cossim\n"
        "from vitta_tpu_torch.models import layers\n"
        "assert 'cossim' in layers.STAT_TYPES\n"
        "assert layers.fused_bn_relu_stats is fused_bn_relu_stats\n"
        "assert (counters.fwd, counters.bwd) == (0, 0)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'vitta_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_data_layer_imports_no_pil_or_decord():
    """The card's machine has neither PIL nor decord: the data layer and
    the chain that uses it import without them, and no host library is
    built at import."""
    code = (
        "import sys\n"
        "from vitta_tpu_torch.data import (dataset, native, native_decode, "
        "pipeline, records, sampling, transforms, video_reader)\n"
        "from vitta_tpu_torch.data.dataset import PairedTTADataset\n"
        "from vitta_tpu_torch.data.pipeline import Prefetcher\n"
        "from vitta_tpu_torch.adapt.loops import tta_stream, validate\n"
        "from vitta_tpu_torch.config import label_flip_map\n"
        "assert not native._LOADED\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'decord', 'jax', 'jaxlib', 'flax', 'optax', 'vitta_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
