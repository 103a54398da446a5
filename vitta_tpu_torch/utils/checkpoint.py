"""Weights and statistics files: reference checkpoints, the JAX package's
variables, and the reference's source-statistics file pair.

The port's module tree uses the reference checkpoint's own key names
(``base_model.layer1.0.net.conv1.weight``, ``base_model.layer1.0.tam.G.0
.weight``, ``new_fc.weight`` ...), so a reference ``.pth.tar`` loads with
``strict=True`` once DataParallel's ``module.`` prefix is stripped.

``tanet_state_dict_from_jax`` is the inverse of the JAX package's
``convert_tanet_checkpoint`` (vitta_tpu/utils/checkpoint.py:64): it takes
the ``{"params", "batch_stats"}`` trees as numpy arrays, so weights made
by either package serve the other.  ``swin_state_dict_from_jax`` is the
same for Video Swin, the inverse of ``convert_swin_checkpoint``
(vitta_tpu/utils/checkpoint.py:162); ``videomae_state_dict_from_jax``,
``r2plus1d_state_dict_from_jax``, ``i3d_state_dict_from_jax`` and
``i3d_incep_state_dict_from_jax`` for the model zoo, whose CNNs keep the
JAX package's module names.  None of them imports JAX.
``videomae_state_dict`` and ``inflate_swin2d_state_dict`` take a reference
torch state dict (timm's VideoMAE, an image Swin) into the port's modules,
as ``convert_videomae_checkpoint`` and ``inflate_swin2d_checkpoint``
(vitta_tpu/utils/checkpoint.py:226,274) take it into the JAX package's.

``save_stats`` and ``load_reference_stats`` write and read the reference's
object-array ``.npy`` pair (corpus/basics.py:306-307), one entry per norm
layer in ``named_modules()`` order, so that statistics files made by the
reference, the JAX package or this one serve all three.
``save_cossim`` and ``load_reference_cossim`` do the same for the relation-
map file of the cossim mode (one entry per norm layer, None where a layer
has no map).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vitta_tpu_torch.models.resnet import RESNET50_LAYERS
from vitta_tpu_torch.models.swin import relative_position_index


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
            if "tam" in fp:     # TANet(use_tam=False) has none
                sd.update(tam_state_dict_from_jax(
                    fp["tam"], fs["tam"], f"base_model.layer{li}.{bi}.tam"))
    sd["new_fc.weight"] = _t(np.transpose(params["new_fc"]["kernel"]))
    sd["new_fc.bias"] = _t(params["new_fc"]["bias"])
    return sd


def swin_state_dict_from_jax(variables, depths=(2, 2, 18, 2),
                             window_size=(8, 7, 7)) -> Dict[str, torch.Tensor]:
    """JAX Video Swin variables -> the port's (and the reference's) state
    dict, which loads with ``strict=True``: the
    ``relative_position_index`` buffers, constants of ``window_size`` that
    the JAX package does not store, are made here.

    Conv3d kernel (pd,ph,pw,in,out) -> (out,in,pd,ph,pw); Dense (in,out) ->
    (out,in); LayerNorm scale/bias -> weight/bias; the 4-D bias table
    (2wd-1,2wh-1,2ww-1,nh) -> the reference's flat (R, nh)."""
    params = variables["params"]
    bb = params["backbone"]
    sd: Dict[str, torch.Tensor] = {}

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = _t(np.transpose(p["kernel"]))
        if "bias" in p:
            sd[f"{prefix}.bias"] = _t(p["bias"])

    sd["backbone.patch_embed.proj.weight"] = _t(
        np.transpose(bb["patch_embed_proj"]["kernel"], (4, 3, 0, 1, 2)))
    sd["backbone.patch_embed.proj.bias"] = _t(bb["patch_embed_proj"]["bias"])
    ln("backbone.patch_embed.norm", bb["patch_embed_norm"])
    for li, depth in enumerate(depths):
        lp, tp = bb[f"layers_{li}"], f"backbone.layers.{li}"
        for bi in range(depth):
            bp, tb = lp[f"blocks_{bi}"], f"{tp}.blocks.{bi}"
            ln(f"{tb}.norm1", bp["norm1"])
            ln(f"{tb}.norm2", bp["norm2"])
            dense(f"{tb}.attn.qkv", bp["attn"]["qkv"])
            dense(f"{tb}.attn.proj", bp["attn"]["proj"])
            table = np.asarray(bp["attn"]["rpb_table"])
            sd[f"{tb}.attn.relative_position_bias_table"] = _t(
                table.reshape(-1, table.shape[-1]))
            sd[f"{tb}.attn.relative_position_index"] = torch.from_numpy(
                relative_position_index(tuple(window_size)).copy())
            dense(f"{tb}.mlp.fc1", bp["mlp"]["fc1"])
            dense(f"{tb}.mlp.fc2", bp["mlp"]["fc2"])
        if "downsample" in lp:
            ln(f"{tp}.downsample.norm", lp["downsample"]["norm"])
            dense(f"{tp}.downsample.reduction", lp["downsample"]["reduction"])
    ln("backbone.norm", bb["norm"])
    dense("cls_head.fc_cls", params["cls_head"]["fc_cls"])
    return sd


def _flax_modules(params, path=()):
    """(path, {leaf: array}) of every module of a flax params tree that
    holds arrays, depth first."""
    leaves = {k: v for k, v in params.items() if not hasattr(v, "items")}
    if leaves:
        yield path, leaves
    for k, v in params.items():
        if hasattr(v, "items"):
            yield from _flax_modules(v, path + (k,))


def _lookup(tree, path):
    for k in path:
        if not hasattr(tree, "items") or k not in tree:
            return None
        tree = tree[k]
    return tree


def state_dict_from_flax(variables, rename=lambda path: ".".join(path)
                          ) -> Dict[str, torch.Tensor]:
    """A flax model's variables -> the state dict of the port's module of
    the same tree, named by ``rename(path)``: a 5-D conv kernel (kt, kh, kw,
    in, out) -> (out, in, kt, kh, kw); a Dense kernel (in, out) -> (out,
    in); scale / bias -> weight / bias, with mean / var -> running_mean /
    running_var where the module has batch statistics (a BatchNorm), none
    where it has not (a LayerNorm)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for path, leaves in _flax_modules(params):
        prefix = rename(path)
        if "kernel" in leaves:
            k = np.asarray(leaves["kernel"])
            axes = (4, 3, 0, 1, 2) if k.ndim == 5 else (1, 0)
            sd[f"{prefix}.weight"] = _t(np.transpose(k, axes))
            if "bias" in leaves:
                sd[f"{prefix}.bias"] = _t(leaves["bias"])
        elif "scale" in leaves:
            bn = _lookup(stats, path)
            if bn is not None:
                _bn(sd, prefix, leaves, bn)
            else:
                sd[f"{prefix}.weight"] = _t(leaves["scale"])
                sd[f"{prefix}.bias"] = _t(leaves["bias"])
        else:
            raise ValueError(f"unknown flax module {'/'.join(path)}: "
                             f"{sorted(leaves)}")
    return sd


def r2plus1d_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``R2Plus1D`` variables -> the port's ``R2Plus1D`` state dict
    (the same module names)."""
    return state_dict_from_flax(variables)


def i3d_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``I3D`` (any depth) variables -> the port's ``I3D`` state
    dict."""
    return state_dict_from_flax(variables)


def i3d_incep_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``InceptionI3d`` variables -> the port's ``InceptionI3d`` state
    dict."""
    return state_dict_from_flax(variables)


def videomae_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``VideoMAE`` variables -> the port's ``VideoMAE`` state dict,
    whose names are timm's: ``patch_embed`` -> ``patch_embed.proj``,
    ``blocks_3`` -> ``blocks.3``."""
    def rename(path):
        head = path[0]
        if head == "patch_embed":
            head = "patch_embed.proj"
        elif head.startswith("blocks_"):
            head = "blocks." + head[len("blocks_"):]
        return ".".join((head,) + tuple(path[1:]))
    return state_dict_from_flax(variables, rename)


def videomae_state_dict(sd, depth: int = 12) -> Dict[str, torch.Tensor]:
    """A VideoMAE fine-tuned torch state dict (timm's keys, ``model`` and
    ``module.`` wrappers allowed) -> the port's ``VideoMAE`` state dict,
    which loads with ``strict=True`` (vitta_tpu/utils/checkpoint.py:226):
    separate ``q_bias`` / ``v_bias`` become the qkv bias with a zero k bias,
    ``fc_norm`` (or ``norm``) the final norm; the keys the model does not
    have (``pos_embed`` ...) are left out."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    sd = {k: torch.as_tensor(v).to(torch.float32)
          for k, v in strip_module_prefix(sd).items()}
    out: Dict[str, torch.Tensor] = {}

    def take(dst, src=None):
        out[dst] = sd[src or dst].clone()

    take("patch_embed.proj.weight")
    take("patch_embed.proj.bias")
    for i in range(depth):
        tb = f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.proj", "mlp.fc1", "mlp.fc2"):
            take(f"{tb}.{name}.weight")
            take(f"{tb}.{name}.bias")
        take(f"{tb}.attn.qkv.weight")
        if f"{tb}.attn.qkv.bias" in sd:
            take(f"{tb}.attn.qkv.bias")
        else:
            q, v = sd[f"{tb}.attn.q_bias"], sd[f"{tb}.attn.v_bias"]
            out[f"{tb}.attn.qkv.bias"] = torch.cat(
                [q, torch.zeros_like(q), v])
    norm = "fc_norm" if "fc_norm.weight" in sd else "norm"
    take("norm.weight", f"{norm}.weight")
    take("norm.bias", f"{norm}.bias")
    take("head.weight")
    take("head.bias")
    return out


def inflate_swin2d_state_dict(sd, num_classes: Optional[int] = None,
                              patch_t: int = 2, window_t: int = 8,
                              window_hw=(7, 7)) -> Dict[str, torch.Tensor]:
    """An image Swin state dict -> the port's Video Swin state dict
    (vitta_tpu/utils/checkpoint.py:274, ``SwinTransformer3D.inflate_weights``
    of swin_transformer.py:563-614): ``patch_embed.proj`` (C, 3, ph, pw)
    replicated over ``patch_t`` frames and divided by it, each relative
    position bias table tiled over the 2 * window_t - 1 temporal offsets,
    every other key under ``backbone.``; the 2D head dropped where
    ``num_classes`` is given, and then a head drawn from
    ``numpy.random.default_rng(0)`` (normal, std 0.01) unless the dict has
    ``cls_head``.  The ``relative_position_index`` buffers are made for the
    3D window; the depths are the state dict's own."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    sd = {k: np.asarray(torch.as_tensor(v).to(torch.float32))
          for k, v in strip_module_prefix(sd).items()}
    full = {}
    for k, v in sd.items():
        if k == "patch_embed.proj.weight":
            v = np.repeat(v[:, :, None], patch_t, axis=2) / float(patch_t)
        elif k.endswith("relative_position_bias_table"):
            v = np.tile(v, (2 * window_t - 1, 1))
        elif k.endswith("relative_position_index") or "attn_mask" in k:
            continue
        full["backbone." + k] = v
    if num_classes is not None:
        full.pop("backbone.head.weight", None)
        full.pop("backbone.head.bias", None)
        if "cls_head.fc_cls.weight" not in full:
            rng = np.random.default_rng(0)
            feat = full["backbone.norm.weight"].shape[0]
            full["cls_head.fc_cls.weight"] = rng.normal(
                0, 0.01, (num_classes, feat)).astype(np.float32)
            full["cls_head.fc_cls.bias"] = np.zeros(num_classes, np.float32)
    index = torch.from_numpy(
        relative_position_index((window_t, *window_hw)).copy())
    out: Dict[str, torch.Tensor] = {}
    for key, v in full.items():
        if key.startswith("backbone.head."):
            continue      # the image classifier; Video Swin's is cls_head
        out[key] = _t(v)
        if key.endswith("relative_position_bias_table"):
            out[key[:-len("bias_table")] + "index"] = index.clone()
    return out


def tanet_norm_layers(use_tam: bool = True) -> List[Tuple[str, str]]:
    """Norm layers of TANet in the torch ``named_modules()`` order used by
    ``choose_layers`` (utils/BNS_utils.py:245-259): per bottleneck net.bn1,
    net.bn2, net.bn3, [downsample bn], tam.G bn1d, tam.L bn1d.  Returns
    ``[(tap_name, kind)]`` with kind in {"bn2d", "bn1d"}
    (vitta_tpu/utils/checkpoint.py:117)."""
    out: List[Tuple[str, str]] = [("base_model.bn1", "bn2d")]
    for li, (_planes, blocks, _s) in enumerate(RESNET50_LAYERS, start=1):
        for bi in range(blocks):
            p = f"base_model.layer{li}_{bi}"
            out += [(f"{p}.bn1", "bn2d"), (f"{p}.bn2", "bn2d"),
                    (f"{p}.bn3", "bn2d")]
            if bi == 0:
                out.append((f"{p}.downsample_bn", "bn2d"))
            if use_tam:
                out += [(f"{p}.tam.g_bn", "bn1d"), (f"{p}.tam.l_bn", "bn1d")]
    return out


def swin_norm_layers(depths=(2, 2, 18, 2)) -> List[Tuple[str, str]]:
    """LayerNorm order of Video Swin, all LN except the patch-embed one
    (corpus/basics.py:500-505): per block norm1, norm2; the PatchMerging
    norm after each of stages 0-2; the final backbone.norm
    (vitta_tpu/utils/checkpoint.py:142)."""
    out: List[Tuple[str, str]] = []
    for si, d in enumerate(depths):
        for bi in range(d):
            p = f"backbone.layers_{si}.blocks_{bi}"
            out += [(f"{p}.norm1", "ln"), (f"{p}.norm2", "ln")]
        if si < len(depths) - 1:
            out.append((f"backbone.layers_{si}.downsample.norm", "ln"))
    out.append(("backbone.norm", "ln"))
    return out


def _stat_layers(arch: str, use_tam: bool, include_bn1d: bool, depths):
    if arch == "tanet":
        return [name for name, kind in tanet_norm_layers(use_tam)
                if kind == "bn2d" or include_bn1d]
    if arch == "videoswintransformer":
        return [name for name, _ in swin_norm_layers(depths)]
    # as vitta_tpu/utils/checkpoint.py:345: no statistics file layout for
    # the model zoo
    raise NotImplementedError(
        f"arch={arch}: statistics files are laid out for tanet and "
        "videoswintransformer only")


def load_reference_stats(mean_file: str, var_file: str, arch: str,
                         use_tam: bool = True, include_bn1d: bool = False,
                         depths=(2, 2, 18, 2)) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The reference's object-array ``.npy`` pair as
    ``{tap_name: (mean, var)}`` (vitta_tpu/utils/checkpoint.py:313).  For
    TANet the files hold one entry per BatchNorm2d; the temporal statistic
    types include the TAM's BatchNorm1d layers too (``include_bn1d``).
    The files are pickled object arrays: load only files this program, the
    JAX package or the reference wrote."""
    means = list(np.load(mean_file, allow_pickle=True))
    variances = list(np.load(var_file, allow_pickle=True))
    names = _stat_layers(arch, use_tam, include_bn1d, depths)
    if not len(means) == len(variances) == len(names):
        raise ValueError(f"{len(means)} means and {len(variances)} variances "
                         f"for {len(names)} norm layers of {arch}")
    return {name: (np.asarray(m, np.float32), np.asarray(v, np.float32))
            for name, m, v in zip(names, means, variances)}


def save_stats(path_mean: str, path_var: str,
               stats: Dict[str, Tuple[np.ndarray, np.ndarray]], arch: str,
               use_tam: bool = True, include_bn1d: bool = False,
               depths=(2, 2, 18, 2)) -> None:
    """Write ``stats`` in the reference's object-array layout
    (vitta_tpu/utils/checkpoint.py:379)."""
    names = _stat_layers(arch, use_tam, include_bn1d, depths)

    def obj_array(items):
        # np.array(list, dtype=object) mis-broadcasts when entries share a
        # leading dimension; build the ragged array explicitly
        arr = np.empty(len(items), dtype=object)
        for i, it in enumerate(items):
            arr[i] = it
        return arr

    np.save(path_mean, obj_array([np.asarray(stats[n][0]) for n in names]),
            allow_pickle=True)
    np.save(path_var, obj_array([np.asarray(stats[n][1]) for n in names]),
            allow_pickle=True)


def load_reference_cossim(path: str, arch: str = "tanet",
                          use_tam: bool = True, depths=(2, 2, 18, 2)
                          ) -> Dict[str, Optional[np.ndarray]]:
    """A ``list_{stat_type}_relationmap_*.npy`` file as
    ``{tap_name: sim_vec or None}`` (vitta_tpu/utils/checkpoint.py:346).
    The file holds one entry per norm layer in ``choose_layers`` order, None
    at layers without a relation map (basics.py:328-338,397-401); those stay
    None so that the engine skips them as the reference's registration does
    (basics.py:916).  A pickled object array: load only files this program,
    the JAX package or the reference wrote."""
    entries = list(np.load(path, allow_pickle=True))
    names = _stat_layers(arch, use_tam, True, depths)   # every norm layer
    if len(entries) != len(names):
        raise ValueError(f"{len(entries)} entries for {len(names)} norm "
                         f"layers of {arch}")
    return {name: (None if e is None else np.asarray(e, np.float32))
            for name, e in zip(names, entries)}


def save_cossim(path: str, sims: Dict[str, Optional[np.ndarray]], arch: str,
                use_tam: bool = True, depths=(2, 2, 18, 2)) -> None:
    """Write relation-map vectors in the reference layout: one object-array
    entry per norm layer, None where ``sims`` has no map
    (vitta_tpu/utils/checkpoint.py:365)."""
    names = _stat_layers(arch, use_tam, True, depths)   # every norm layer
    arr = np.empty(len(names), dtype=object)
    for i, name in enumerate(names):
        arr[i] = (np.asarray(sims[name], np.float32)
                  if sims.get(name) is not None else None)
    np.save(path, arr, allow_pickle=True)
