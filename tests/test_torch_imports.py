"""The port stands alone: importing all of vitta_tpu_torch loads neither
JAX (nor flax, optax or orbax) nor the JAX package; importing its data
layer loads neither PIL nor decord and builds nothing; the baselines, the
CLI and its scripts import without a card, touch no device and write
nothing."""

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
                 "data.dataset", "data.pipeline", "baselines",
                 "baselines.common", "baselines.source", "baselines.norm",
                 "baselines.tent", "baselines.shot", "baselines.dua",
                 "baselines.t3a", "cli.opts", "cli.main_eval", "cli.drivers",
                 "adapt.stream_ckpt", "utils.logging", "utils.observability",
                 "scripts.tta_tanet_ucf101", "scripts.tta_swin_ucf101",
                 "scripts.sourceonly_ucf101_corr", "scripts.compute_stats",
                 "models.videomae", "models.r2plus1d", "models.i3d",
                 "models.i3d_incep", "scripts.tta_swin_kinetics",
                 "scripts.tta_swin_ssv2", "utils.checkpoint"):
        assert f"vitta_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vitta_tpu'))\n"
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


def test_baselines_and_cli_import_without_jax_or_a_card():
    """The baselines, the CLI, the mid-stream checkpoint and the entry
    scripts, from a process that never saw JAX: importing them resolves no
    device and builds nothing; their run device is the card unless
    VITTA_PLATFORM=cpu."""
    code = (
        "import os, sys\n"
        "from vitta_tpu_torch.baselines import BASELINES, setup_baseline\n"
        "from vitta_tpu_torch.cli import drivers, main_eval, opts\n"
        "from vitta_tpu_torch.adapt.stream_ckpt import StreamCheckpointer\n"
        "from vitta_tpu_torch.utils.logging import ResultWriter, get_logger\n"
        "from vitta_tpu_torch.utils.observability import (MetricsWriter, "
        "StepTimer, profile)\n"
        "from vitta_tpu_torch.scripts import (compute_stats, "
        "sourceonly_ucf101_corr, tta_swin_ucf101, tta_tanet_ucf101)\n"
        "from vitta_tpu_torch.data import native\n"
        "assert sorted(BASELINES) == ['dua', 'norm', 'shot', 'source', "
        "'t3a', 'tent']\n"
        "assert not native._LOADED\n"
        "os.environ['VITTA_PLATFORM'] = 'cpu'\n"
        "assert str(opts.run_device()) == 'cpu'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vitta_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_model_zoo_and_its_drivers_import_without_jax():
    """VideoMAE, R(2+1)D, I3D and Inception-I3D, their converters, the
    zoo's set-up helpers and the Kinetics-400-C and SSv2-C drivers, from a
    process that never saw JAX: building the models touches no device."""
    code = (
        "import sys\n"
        "from vitta_tpu_torch.models.videomae import VideoMAE, ViTBlock\n"
        "from vitta_tpu_torch.models.r2plus1d import R2Plus1D, Conv2Plus1D\n"
        "from vitta_tpu_torch.models.i3d import I3D, I3DResNet, I3D_DEPTHS\n"
        "from vitta_tpu_torch.models.i3d_incep import InceptionI3d\n"
        "from vitta_tpu_torch.models.layers import conv_ndhwc\n"
        "from vitta_tpu_torch.utils.checkpoint import (videomae_state_dict, "
        "inflate_swin2d_state_dict, r2plus1d_state_dict_from_jax, "
        "i3d_state_dict_from_jax, i3d_incep_state_dict_from_jax, "
        "videomae_state_dict_from_jax)\n"
        "from vitta_tpu_torch.tools.synthetic import ZOO_MODELS, zoo_model\n"
        "from vitta_tpu_torch.scripts import tta_swin_kinetics, "
        "tta_swin_ssv2\n"
        "assert sorted(ZOO_MODELS) == ['i3d_incep', 'i3d_resnet18', "
        "'i3d_resnet50', 'r2plus1d', 'tanet_no_tam', 'videomae']\n"
        "m = R2Plus1D(3)\n"
        "assert next(m.parameters()).device.type == 'cpu'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vitta_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
