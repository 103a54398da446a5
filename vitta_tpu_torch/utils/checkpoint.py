"""TANet weights: reference checkpoints, and the JAX package's variables.

The port's module tree uses the reference checkpoint's own key names
(``base_model.layer1.0.net.conv1.weight``, ``base_model.layer1.0.tam.G.0
.weight``, ``new_fc.weight`` ...), so a reference ``.pth.tar`` loads with
``strict=True`` once DataParallel's ``module.`` prefix is stripped.

``tanet_state_dict_from_jax`` is the inverse of the JAX package's
``convert_tanet_checkpoint`` (vitta_tpu/utils/checkpoint.py:64): it takes
the ``{"params", "batch_stats"}`` trees as numpy arrays, so weights made
by either package serve the other.  Neither function imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vitta_tpu_torch.models.resnet import RESNET50_LAYERS


def strip_module_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop DataParallel's ``module.`` prefix (main_eval.py:55-65)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference TANet ``.pth.tar`` as a state dict for ``TANet``.  Loads
    tensors only (``weights_only``): a checkpoint cannot run code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return strip_module_prefix(sd)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))   # a writable copy


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))


def tam_state_dict_from_jax(params, stats, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One JAX ``TAM``'s params and batch_stats -> the state dict of the
    port's ``TAM`` (keys ``G.0.weight`` ..., under ``prefix``)."""
    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, torch.Tensor] = {}
    sd[f"{pre}G.0.weight"] = _t(np.transpose(params["g_fc1"]["kernel"]))
    _bn(sd, f"{pre}G.1", params["g_bn"], stats["g_bn"])
    sd[f"{pre}G.3.weight"] = _t(np.transpose(params["g_fc2"]["kernel"]))
    sd[f"{pre}L.0.weight"] = _t(
        np.transpose(params["l_conv1"]["kernel"], (2, 1, 0)))
    _bn(sd, f"{pre}L.1", params["l_bn"], stats["l_bn"])
    sd[f"{pre}L.3.weight"] = _t(
        np.transpose(params["l_conv2"]["kernel"], (2, 1, 0)))
    return sd


def tanet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX TANet variables -> the port's (and the reference's) state dict.

    conv (kh,kw,in,out) -> (out,in,kh,kw); Dense (in,out) -> (out,in);
    TAM Conv1d (k,in,out) -> (out,in,k); scale/bias -> weight/bias;
    mean/var -> running_mean/running_var."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["base_model"], stats["base_model"]
    _conv(sd, "base_model.conv1", bp["conv1"])
    _bn(sd, "base_model.bn1", bp["bn1"], bs["bn1"])
    for li, (_planes, blocks, _stride) in enumerate(RESNET50_LAYERS, start=1):
        for bi in range(blocks):
            fp, fs = bp[f"layer{li}_{bi}"], bs[f"layer{li}_{bi}"]
            net = f"base_model.layer{li}.{bi}.net"
            for ci in (1, 2, 3):
                _conv(sd, f"{net}.conv{ci}", fp[f"conv{ci}"])
                _bn(sd, f"{net}.bn{ci}", fp[f"bn{ci}"], fs[f"bn{ci}"])
            if "downsample_conv" in fp:
                _conv(sd, f"{net}.downsample.0", fp["downsample_conv"])
                _bn(sd, f"{net}.downsample.1", fp["downsample_bn"],
                    fs["downsample_bn"])
            sd.update(tam_state_dict_from_jax(
                fp["tam"], fs["tam"], f"base_model.layer{li}.{bi}.tam"))
    sd["new_fc.weight"] = _t(np.transpose(params["new_fc"]["kernel"]))
    sd["new_fc.bias"] = _t(params["new_fc"]["bias"])
    return sd
