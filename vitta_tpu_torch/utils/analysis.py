"""Model analysis — the PyTorch counterpart of vitta_tpu/utils/analysis.py
(reference utils/utils_.py:113-121): parameter counts (total, trainable,
BatchNorm running-statistic buffers) and a name / shape table.

Names are the JAX package's flattened module names, which the port's taps
already use (``base_model.layer3_0.bn1``): a norm layer's ``tap_name``,
and elsewhere the torch path with each list index joined to its module's
name (``layer3.0`` -> ``layer3_0``).
"""

from __future__ import annotations

import re
from typing import Collection, Dict, Mapping, Optional, Union

import torch

_INDEX = re.compile(r"\.(\d+)(?=\.|$)")

# the buffers vitta_tpu keeps in ``batch_stats`` (its ``mean`` and ``var``;
# torch's ``num_batches_tracked`` has no counterpart)
_BN_BUFFERS = ("running_mean", "running_var")


def count_params(tree) -> int:
    """Elements of every tensor in ``tree``: a module's parameters, a
    ``{name: tensor}`` dict, or an iterable of tensors."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.parameters()
    elif isinstance(tree, Mapping):
        tree = tree.values()
    return sum(int(t.numel()) for t in tree)


def _jax_names(model: torch.nn.Module) -> Dict[str, str]:
    """{torch parameter name: the JAX package's flattened name}."""
    out = {}
    for mod_name, mod in model.named_modules():
        base = getattr(mod, "tap_name", None) or _INDEX.sub(r"_\1", mod_name)
        for leaf, _p in mod.named_parameters(recurse=False):
            torch_name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[torch_name] = f"{base}.{leaf}" if base else leaf
    return out


def model_analysis(model: torch.nn.Module,
                   trainable: Optional[Union[Mapping[str, bool],
                                             Collection[str]]] = None,
                   logger=None) -> dict:
    """Total and trainable parameter counts and the BatchNorm buffers'
    (running mean and variance) of ``model``.  ``trainable`` is a
    ``{name: bool}`` mask (``adapt/optim.py:tanet_trainable_mask``) or a
    collection of parameter names; by default the parameters with
    ``requires_grad``."""
    params = dict(model.named_parameters())
    if trainable is None:
        chosen = [p for p in params.values() if p.requires_grad]
    elif isinstance(trainable, Mapping):
        chosen = [params[k] for k, on in trainable.items() if on]
    else:
        chosen = [params[k] for k in trainable]
    info = {"total_params": count_params(params),
            "trainable_params": count_params(chosen),
            "batch_stat_buffers": count_params(
                b for k, b in model.named_buffers()
                if k.rsplit(".", 1)[-1] in _BN_BUFFERS)}
    if logger:
        logger.info(f"Parameter number: {info['total_params']:,} "
                    f"(trainable {info['trainable_params']:,}; BN buffers "
                    f"{info['batch_stat_buffers']:,})")
    return info


def param_table(model: torch.nn.Module, max_rows: Optional[int] = None) -> str:
    """One ``name shape dtype`` line a parameter (the structure dump), by
    the JAX package's flattened names."""
    names = _jax_names(model)
    rows = []
    for k, p in model.named_parameters():
        rows.append(f"{names[k]:70s} {str(tuple(p.shape)):20s} "
                    f"{str(p.dtype).removeprefix('torch.')}")
        if max_rows and len(rows) >= max_rows:
            rows.append("...")
            break
    return "\n".join(rows)
