"""Video Swin Transformer (Swin-B) — the PyTorch counterpart of
vitta_tpu/models/swin.py on its spatial path.

The reference backbone (models/videoswintransformer_models/
swin_transformer.py):

* ``PatchEmbed3D`` Conv3d patchify + LayerNorm (:416-456; this first LN is
  excluded from the statistic taps, corpus/basics.py:503-505);
* 4 stages of ``SwinBlock3D`` (:172-274) — windowed 3D attention with
  relative-position bias (:87-169), cyclic shift on odd blocks, attention
  masks for shifted windows (:316-329), stochastic depth; ``PatchMerging``
  2x2 spatial between stages (:277-312);
* final LayerNorm over (B, D, H, W, C) (:659-661);
* ``I3DHead`` avg-pool + Dropout(0.5) + Linear (i3d_head.py:25-77);
* ``Recognizer3D`` takes the views folded into the batch and returns
  per-view logits (recognizer3d.py:95-115).

Everything stays channels-last (B, D, H, W, C), as in the JAX package.
Parameter and buffer names are the reference checkpoint's
(``backbone.layers.2.blocks.1.attn.relative_position_bias_table`` flat
(R, nh), ``relative_position_index`` as a buffer), so a reference state
dict loads with ``strict=True``; tap names are the JAX package's flattened
ones (``backbone.layers_2.blocks_1.norm1``).

Where the work goes on a CUDA tensor, forward and backward: every
LayerNorm but norm2 through ops/cuda_ln.py, the bias expansion (and its
collapse) through ops/cuda_bias.py, the attention between the qkv and the
output projection through ops/cuda_attention.py, and norm2 + MLP through
ops/cuda_mlp.py — hand-written kernels, with no gate on the width or the
row count; each keeps what its backward reads only when a gradient is
wanted.  Under ``train=True`` drop-path and the head's dropout draw from
the caller's ``torch.Generator`` on the input's device.  The qkv, proj,
PatchMerging and head projections are ``F.linear`` and the patch embedding
is ``nn.Conv3d``, as the JAX package leaves them to XLA.  A clamped window
(input smaller than the configured window) takes the reference's gather and
plain attention on every device, as it does in the JAX package.

That is the default, packed, attention route.  ``attn_route`` (an argument
of every module from ``Recognizer3D`` down to ``SwinBlock3D``, which
resolves it once, at construction, and hands its attention a concrete route
per call; None reads the environment flags of ops/dispatch.py, any other
value reads nothing of the environment) chooses between it and the
two projection-fused forms of vitta_tpu/models/swin.py:243-254, :361-386,
which run through ops/cuda_attention_proj.py with the qkv and output
projections inside the op:

* ``"proj"``: norm1 stays a standalone LayerNorm; bias expansion and one op;
* ``"ln_proj"``: norm1 moves into the op as well; roll and window partition
  then act on the un-normalized x (LayerNorm is token-wise), and the op
  returns the LayerNorm output in window layout for the output-side tap.
  Only a block that pads nothing and whose taps are spatiotemp alone (the
  one statistic that does not depend on the token order) takes this form;
  any other falls back: to ``"proj"``, or under None to what
  ``VITTA_ATTN_PROJ_FUSED`` says (``dispatch.resolve_attn_route``).

No route changes a parameter, a ``state_dict`` key or a tap name.

Not ported, being layouts of the TPU and no change of the math: the
window-resident stage form, the patchify-matmul patch embedding, and the
scoped-VMEM gates that move Swin-B's fourth stage to other kernels.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vitta_tpu_torch.models.layers import LayerNorm, layer_norm
from vitta_tpu_torch.models.tanet import dropout
from vitta_tpu_torch.ops._launch import contiguous_counted as _contiguous
from vitta_tpu_torch.ops._launch import copy_counters as counters  # noqa: F401
from vitta_tpu_torch.ops.cuda_attention import (attention_reference,
                                                window_attention_packed)
from vitta_tpu_torch.ops.cuda_attention_proj import (window_attention_ln_proj,
                                                     window_attention_proj)
from vitta_tpu_torch.ops.cuda_bias import compact_bias, expand_bias
from vitta_tpu_torch.ops.cuda_mlp import ln_mlp
from vitta_tpu_torch.ops.dispatch import resolve_attn_route

# ``counters.contiguity_copies``: copies made only to hand a kernel a
# contiguous tensor, since ``counters.reset()``: activations in the forward
# below and cotangents in the backward of the four ops

def get_window_size(x_size, window_size, shift_size=None):
    """Clamp window/shift to the input size (swin_transformer.py:25-35)."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i in range(3):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            if use_shift is not None:
                use_shift[i] = 0
    if shift_size is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


def window_partition(x, window_size):
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C) (swin_transformer.py:38-51)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window_size
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows, window_size, b, d, h, w):
    wd, wh, ww = window_size
    c = windows.shape[-1]
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


@functools.lru_cache(maxsize=32)
def relative_position_index(window_size: Tuple[int, int, int]) -> np.ndarray:
    """(N, N) index into the bias table (swin_transformer.py:109-128).
    Cached: treat the result as read-only."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij"))          # (3, wd, wh, ww)
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # (3, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += wd - 1
    rel[..., 1] += wh - 1
    rel[..., 2] += ww - 1
    rel[..., 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[..., 1] *= (2 * ww - 1)
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def compute_shift_mask(dp: int, hp: int, wp: int,
                       window_size: Tuple[int, int, int],
                       shift_size: Tuple[int, int, int]) -> Optional[np.ndarray]:
    """Attention mask (nW, N, N) of 0 / -100 for shifted windows
    (swin_transformer.py:316-329); None when no shift.  Cached: treat the
    result as read-only."""
    if not any(shift_size):
        return None
    wd, wh, ww = window_size
    sd, sh, sw = shift_size
    img = np.zeros((1, dp, hp, wp, 1), np.float32)
    cnt = 0
    # literal replication of the reference slice triples
    # (swin_transformer.py:316-326), including the slice(-0) == empty and
    # slice(0, None) == full-axis quirks when a shift component is zero.
    for d in (slice(-wd), slice(-wd, -sd), slice(-sd, None)):
        for h in (slice(-wh), slice(-wh, -sh), slice(-sh, None)):
            for w in (slice(-ww), slice(-ww, -sw), slice(-sw, None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    n = wd * wh * ww
    win = img.reshape(1, dp // wd, wd, hp // wh, wh, wp // ww, ww, 1)
    win = win.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, n)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def drop_path(x, rate: float, train: bool,
              generator: Optional[torch.Generator]):
    """Per-sample stochastic depth (timm DropPath semantics,
    vitta_tpu/models/swin.py:257-279): one draw per sample of dim 0
    decides whether its whole residual branch is dropped; the kept ones
    are scaled by 1/keep."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                      generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class WindowAttention3D(nn.Module):
    """Window MSA with 3D relative position bias
    (swin_transformer.py:87-169)."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int):
        super().__init__()
        self.dim = dim
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(self.window_size).copy()))
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)
        self._mask_cache = {}

    def _mask(self, mask_np, key, device):
        """The shift mask as a tensor on ``device``, made once per shape."""
        if mask_np is None:
            return None
        key = (key, str(device))
        if key not in self._mask_cache:
            self._mask_cache[key] = torch.from_numpy(mask_np).to(device)
        return self._mask_cache[key]

    def forward(self, x, mask_np=None, mask_key=None, route="packed",
                ln=None):
        """x: (B_, n, C) windows; ``mask_np`` the (nW, n, n) numpy shift
        mask or None, ``mask_key`` what identifies it.  ``route`` is what
        the block resolved for this call: ``"packed"`` or ``"proj"``
        without ``ln``; ``"ln_proj"`` with ``ln`` = (gamma, beta, eps) of
        the preceding LayerNorm (norm1) and ``x`` un-normalized, and the
        call then returns (out, y) with y the LayerNorm output
        (vitta_tpu/models/swin.py:188-254)."""
        if (route == "ln_proj") != (ln is not None):
            raise ValueError("route 'ln_proj' and ln=(gamma, beta, eps) go "
                             "together")
        b_, n, c = x.shape
        nh = self.num_heads
        wd, wh, ww = self.window_size
        mask = self._mask(mask_np, mask_key, x.device)
        full = n == wd * wh * ww
        if full:
            bias = expand_bias(
                compact_bias(self.relative_position_bias_table,
                             self.window_size), wd)       # (nh, N, N)
        if full and ln is not None:
            return window_attention_ln_proj(
                _contiguous(x), ln[0], ln[1], ln[2], self.qkv.weight,
                self.qkv.bias, self.proj.weight, self.proj.bias, bias, mask,
                self.scale, nh)
        y = x if ln is None else layer_norm(x, *ln)
        if full and route == "proj":
            out = window_attention_proj(
                _contiguous(y), self.qkv.weight, self.qkv.bias,
                self.proj.weight, self.proj.bias, bias, mask, self.scale, nh)
            return out if ln is None else (out, y)
        qkv = self.qkv(y)                                  # (B_, n, 3C)
        if full:
            out = window_attention_packed(_contiguous(qkv), bias, mask,
                                          self.scale, nh)
        else:
            # clamped effective window (input smaller than the window):
            # the first n positions of the configured flattening are not a
            # sub-box, so keep the reference's sliced gather and the plain
            # attention here (tiny inputs only; swin_transformer.py:138-147)
            idx = self.relative_position_index[:n, :n].reshape(-1)
            bias = self.relative_position_bias_table[idx].reshape(
                n, n, nh).permute(2, 0, 1)
            q5 = qkv.reshape(b_, n, 3, nh, c // nh)
            out = attention_reference(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2],
                                      bias, mask, self.scale).reshape(b_, n, c)
        out = self.proj(out)
        return out if ln is None else (out, y)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (swin_transformer.py:48-65); owns the
    parameters only: the block runs them through the fused LayerNorm-MLP
    op together with norm2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock3D(nn.Module):
    """SwinTransformerBlock3D (swin_transformer.py:172-274)."""

    def __init__(self, dim: int, num_heads: int, tap_prefix: str,
                 window_size=(8, 7, 7), shift_size=(0, 0, 0),
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 attn_route: Optional[str] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, f"{tap_prefix}.norm1",
                               stat_types=stat_types)
        # resolved here, once: this is the layer that knows the taps and
        # the padding, and it hands the attention a concrete route per call
        self.attn_route, self.attn_fallback = resolve_attn_route(attn_route)
        if (self.attn_route == "ln_proj"
                and tuple(stat_types) != ("spatiotemp",)):
            # the op returns y in window layout: only the token-order-
            # invariant spatiotemp tap may read it
            self.attn_route = self.attn_fallback
        self.attn = WindowAttention3D(dim, self.window_size, num_heads)
        self.norm2 = LayerNorm(dim, f"{tap_prefix}.norm2",
                               stat_types=stat_types)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, taps=None, *, train: bool = False, generator=None):
        """x: (B, D, H, W, C) -> the same shape."""
        b, d, h, w, c = x.shape
        window, shift = get_window_size((d, h, w), self.window_size,
                                        self.shift_size)
        shortcut = x
        wd, wh, ww = window
        pad_d, pad_h, pad_w = (-d) % wd, (-h) % wh, (-w) % ww
        padded = bool(pad_d or pad_h or pad_w)
        # norm1 inside the attention op: gated off under padding, since
        # LayerNorm(0-pad) != 0
        route = self.attn_route
        if route == "ln_proj" and padded:
            route = self.attn_fallback
        fuse_ln = route == "ln_proj"
        if not fuse_ln:
            x = self.norm1(_contiguous(x), taps)
        if padded:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
        dp, hp, wp = d + pad_d, h + pad_h, w + pad_w
        mask_np = compute_shift_mask(dp, hp, wp, window, shift)
        if any(shift):
            x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]),
                           dims=(1, 2, 3))
        # the bias table and index are sized by the CONFIGURED window; the
        # attention slices [:n, :n] when the effective window is clamped
        mask_key = (dp, hp, wp, window, shift)
        if fuse_ln:
            # the module still owns the parameters and records both tap
            # sides: the input here, the output from the y the op returns,
            # counted per sample, not per window
            gamma, beta = self.norm1(shortcut, taps, mode="params")
            attn, ln_out = self.attn(window_partition(x, window), mask_np,
                                     mask_key, route,
                                     ln=(gamma, beta, self.norm1.eps))
            self.norm1(ln_out, taps, mode="sow_output", stat_count=b)
        else:
            attn = self.attn(window_partition(x, window), mask_np, mask_key,
                             route)
        x = window_reverse(attn, window, b, dp, hp, wp)
        if any(shift):
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        if padded:
            x = x[:, :d, :h, :w]
        x = shortcut + drop_path(x, self.drop_path, train, generator)
        return self._mlp_tail(x, taps, train, generator)

    def _mlp_tail(self, x, taps, train, generator):
        """norm2 fused into the MLP op: the module still owns the
        parameters and records both tap sides (the input here, the output
        from the y the op returns), so tap names do not move."""
        gamma, beta = self.norm2(x, taps, mode="params")
        y, ln_out = ln_mlp(_contiguous(x), gamma, beta, self.mlp.fc1.weight,
                           self.mlp.fc1.bias, self.mlp.fc2.weight,
                           self.mlp.fc2.bias, self.norm2.eps)
        self.norm2(ln_out, taps, mode="sow_output")
        return x + drop_path(y, self.drop_path, train, generator)


class PatchMerging(nn.Module):
    """2x2 spatial merge (swin_transformer.py:277-312)."""

    def __init__(self, dim: int, tap_prefix: str,
                 stat_types: Tuple[str, ...] = ("spatiotemp",)):
        super().__init__()
        self.norm = LayerNorm(4 * dim, f"{tap_prefix}.norm",
                              stat_types=stat_types)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, taps=None):
        b, d, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        hp, wp = h + h % 2, w + w % 2
        # the reference gathers the four parity phases with strided slices
        # and concatenates (swin_transformer.py:293-299); the same
        # permutation as a reshape/permute pair, whose channel-block order
        # (j-major, i-minor, then C) is the reference's [x0|x1|x2|x3]
        x = x.reshape(b, d, hp // 2, 2, wp // 2, 2, c)
        x = x.permute(0, 1, 2, 4, 5, 3, 6)
        x = x.reshape(b, d, hp // 2, wp // 2, 4 * c)
        return self.reduction(self.norm(x, taps))


class BasicLayer(nn.Module):
    """One Swin stage (swin_transformer.py:332-413)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size,
                 drop_paths, downsample: bool, tap_prefix: str,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 attn_route: Optional[str] = None):
        super().__init__()
        shift = tuple(s // 2 for s in window_size)
        self.blocks = nn.ModuleList([
            SwinBlock3D(dim, num_heads, f"{tap_prefix}.blocks_{i}",
                        window_size=window_size,
                        shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                        drop_path=drop_paths[i], stat_types=stat_types,
                        attn_route=attn_route)
            for i in range(depth)])
        self.downsample = PatchMerging(
            dim, f"{tap_prefix}.downsample",
            stat_types=stat_types) if downsample else None

    def forward(self, x, taps=None, *, train: bool = False, generator=None):
        for blk in self.blocks:
            x = blk(x, taps, train=train, generator=generator)
        if self.downsample is not None:
            x = self.downsample(x, taps)
        return x


class PatchEmbed3D(nn.Module):
    """Conv3d patchify + LayerNorm without a tap
    (swin_transformer.py:416-456)."""

    def __init__(self, patch_size, embed_dim: int, tap_prefix: str):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(3, embed_dim, kernel_size=self.patch_size,
                              stride=self.patch_size)
        self.norm = LayerNorm(embed_dim, f"{tap_prefix}.patch_embed_norm",
                              tap=False)

    def forward(self, x):
        """(B, T, H, W, 3) -> (B, D, H', W', C)."""
        pd, ph, pw = self.patch_size
        t, h, w = x.shape[1:4]
        if t % pd or h % ph or w % pw:
            x = F.pad(x, (0, 0, 0, (-w) % pw, 0, (-h) % ph, 0, (-t) % pd))
        # the permuted view of a channels-last clip is channels_last_3d
        # memory, which the convolution takes and returns as is; then the
        # view back is contiguous and ``contiguous`` is free
        x = self.proj(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return self.norm(_contiguous(x))


class SwinTransformer3D(nn.Module):
    """Swin-B video backbone (swin_transformer.py:459-661)."""

    def __init__(self, patch_size=(2, 4, 4), embed_dim: int = 128,
                 depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                 window_size=(8, 7, 7), drop_path_rate: float = 0.2,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 tap_prefix: str = "backbone",
                 attn_route: Optional[str] = None):
        super().__init__()
        self.patch_embed = PatchEmbed3D(patch_size, embed_dim, tap_prefix)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        layers, i0 = [], 0
        for li, depth in enumerate(depths):
            layers.append(BasicLayer(
                embed_dim * 2 ** li, depth, num_heads[li], tuple(window_size),
                tuple(dpr[i0:i0 + depth]), li < len(depths) - 1,
                f"{tap_prefix}.layers_{li}", stat_types=stat_types,
                attn_route=attn_route))
            i0 += depth
        self.layers = nn.ModuleList(layers)
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(self.num_features, f"{tap_prefix}.norm",
                              stat_types=stat_types)

    def forward(self, x, taps=None, *, train: bool = False, generator=None):
        """x: (B, T, H, W, 3) -> (B, D, H', W', num_features)."""
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, taps, train=train, generator=generator)
        return self.norm(x, taps)


class I3DHead(nn.Module):
    """AvgPool3d + Dropout(0.5) + Linear (i3d_head.py:25-77)."""

    def __init__(self, in_features: int, num_classes: int,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.fc_cls = nn.Linear(in_features, num_classes)
        nn.init.normal_(self.fc_cls.weight, std=0.01)
        nn.init.zeros_(self.fc_cls.bias)

    def forward(self, x, *, train: bool = False, generator=None):
        x = torch.mean(x.to(torch.float32), dim=(1, 2, 3))       # (B, C)
        if train and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        return self.fc_cls(x)


class Recognizer3D(nn.Module):
    """Backbone + head; views are pre-folded into the batch
    (recognizer3d.py:95-115)."""

    def __init__(self, num_classes: int, patch_size=(2, 4, 4),
                 window_size=(8, 7, 7), embed_dim: int = 128,
                 depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                 drop_path_rate: float = 0.2, head_dropout: float = 0.5,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 attn_route: Optional[str] = None):
        super().__init__()
        self.backbone = SwinTransformer3D(
            patch_size=patch_size, embed_dim=embed_dim, depths=depths,
            num_heads=num_heads, window_size=window_size,
            drop_path_rate=drop_path_rate, stat_types=tuple(stat_types),
            attn_route=attn_route)
        self.cls_head = I3DHead(self.backbone.num_features, num_classes,
                                dropout=head_dropout)

    def forward(self, x, taps: Optional[dict] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_running_average: bool = True,
                update_running_stats: bool = False):
        """x: (B*V, T, H, W, 3) -> per-view logits (B*V, K).  The two
        BatchNorm arguments are the engine's and mean nothing here: the
        model has no running statistics."""
        feats = self.backbone(x, taps, train=train, generator=generator)
        return self.cls_head(feats, train=train, generator=generator)

    def features(self, x):
        feats = self.backbone(x)
        return torch.mean(feats, dim=(1, 2, 3))
