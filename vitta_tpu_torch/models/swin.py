"""Video Swin Transformer (Swin-B) — the PyTorch counterpart of
vitta_tpu/models/swin.py.

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

Where the work goes on a CUDA tensor, forward and backward: the LayerNorms
through ops/cuda_ln.py, the bias expansion (and its collapse) through
ops/cuda_bias.py, the attention between the qkv and the output projection
through ops/cuda_attention.py, and the MLP through ops/cuda_mlp.py, with
norm2 inside that op where ``dispatch.mlp_ln_fused`` holds (widths that are
multiples of 128: all of Swin-B's) and as a LayerNorm of its own in front
of it otherwise (Swin-T's and Swin-S's 96 and 192), the two branches of
vitta_tpu/models/swin.py:428-437 — hand-written kernels; each keeps what
its backward reads only when a gradient is wanted.  Under ``train=True`` drop-path and the head's dropout draw from
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

A fourth value, ``"heads"``, keeps the projections outside as the packed
route does and runs the attention per (head, window) on q, k and v as three
views of the qkv output (``window_attention_heads``): the route vitta_tpu
takes where its packed kernel does not fit.  No flag gives it.

No route changes a parameter, a ``state_dict`` key or a tap name.

The layout variants of vitta_tpu, each the same math, each off unless its
environment flag is on when the module is built (ops/dispatch.py says why
the port's defaults differ from vitta_tpu's):

* ``VITTA_WINDOW_RESIDENT``: ``BasicLayer`` keeps a stage in window layout
  from block to block, one token gather where the layout changes
  (``relayout_index``, ``TokenGather``) in place of the spatial form's
  roll, partition, reverse and roll around every block; each such stage
  adds one to ``counters.window_resident_stages``;
* ``VITTA_PATCHIFY_V2``: ``PatchEmbed3D`` as ``patchify_mm`` times the
  flattened Conv3d weight.

Not ported: the scoped-VMEM gates that move Swin-B's fourth stage to other
kernels, a limit of the TPU's.

``dtype`` (an argument of every module from ``Recognizer3D`` down, "float32"
or "bfloat16", vitta_tpu/models/swin.py's ``dtype``) is the compute dtype.
The parameters stay float32 (the masters).  At bfloat16 the patch
embedding's input, the activations, the residual adds, drop-path and the
window partition and roll are bfloat16; the Conv3d, qkv, proj, fc1, fc2
and PatchMerging's reduction cast their weight and bias to bfloat16 where
they use them, as flax's ``promote_dtype`` does (the gradient of the cast
upcasts the bfloat16 gradient to the float32 master); the LayerNorms'
parameters, the relative-position tables, their bias and the shift mask
stay float32, and so does the head, which pools in float32
(vitta_tpu/models/swin.py:700-705).  The LayerNorm, LayerNorm-MLP, MLP
and attention kernels run at bfloat16.  The packed attention takes the
relative-position bias in its compact form (nh, 2wd-1, hw, hw), with no
expansion kernel, and its backward returns the compact gradient in
vitta_tpu's own order (each window collapsed over its frame pairs, then
the windows added), where float32 expands the bias and collapses the sum
over the windows.  Under ``"heads"`` the bias is expanded to its dense
form at float32 (and its gradient collapsed) at both dtypes, as vitta_tpu
does on that route (pallas_attention.py:696-699), and so it is under
``"proj"`` and ``"ln_proj"``, whose bfloat16 ops
(ops/cuda_attention_proj.py) take the qkv and output projections' weights
and biases at bfloat16 (the engine's ``HalfTwin`` copies where it keeps
them) and round them as flax's Dense does at the compute dtype.  A width
whose norm2 runs apart (Swin-T's 96 and 192) takes the bfloat16 LayerNorm
and the bfloat16 ``mlp``.  Every route runs at bfloat16.  vitta_tpu sends
the blocks whose fused backward overflows the TPU's scoped fast memory
(Swin-B's fourth stage: 104 MB at bfloat16, pallas_attention.py:256-287)
to XLA projections around its packed kernel (:1224-1237), with the same
two roundings (a bfloat16 product plus the bfloat16 bias); the port has no
such gate and runs the fused op at every stage, as it does at float32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vitta_tpu_torch.models.layers import LayerNorm, layer_norm
from vitta_tpu_torch.models.resnet import compute_dtype
from vitta_tpu_torch.models.tanet import dropout
from vitta_tpu_torch.ops._launch import contiguous_counted as _contiguous
from vitta_tpu_torch.ops._launch import copy_counters as counters  # noqa: F401
from vitta_tpu_torch.ops.cuda_attention import (attention_reference,
                                                window_attention_heads,
                                                window_attention_packed)
from vitta_tpu_torch.ops.cuda_attention_proj import (window_attention_ln_proj,
                                                     window_attention_proj)
from vitta_tpu_torch.ops.cuda_bias import compact_bias, expand_bias
from vitta_tpu_torch.ops.cuda_mlp import ln_mlp, mlp
from vitta_tpu_torch.ops.dispatch import (mlp_ln_fused, patchify_v2_enabled,
                                          resolve_attn_route,
                                          window_resident_enabled)

# ``counters.contiguity_copies``: copies made only to hand a kernel a
# contiguous tensor, since ``counters.reset()``: activations in the forward
# below and cotangents in the backward of the four ops.
# ``counters.window_resident_stages``: stages that ran in window layout


def at_dtype(p, dt):
    """A weight or bias ``p`` at the compute dtype ``dt``: the bfloat16
    twin an engine keeps of it (``p.half_twin``, see ``HalfTwin``) where
    there is one, else ``p`` cast here, as flax's ``promote_dtype`` casts
    (the cast's gradient upcasts the bfloat16 gradient to the master)."""
    twin = getattr(p, "half_twin", None)
    return twin if twin is not None and twin.dtype == dt else p.to(dt)


def half_cast_params(model: nn.Module):
    """The parameters a bfloat16 Video Swin casts where it uses them: those
    of every nn.Linear and nn.Conv3d of its backbone (qkv, proj, fc1, fc2,
    PatchMerging's reduction, the patch embedding), as
    vitta_tpu/adapt/engine.py's ``half_cast_flags`` picks the
    kernel-owning modules of the backbone; the norms, the relative-position
    tables and the head stay float32."""
    backbone = getattr(model, "backbone", model)
    return [p for mod in backbone.modules()
            if isinstance(mod, (nn.Linear, nn.Conv3d))
            for p in mod.parameters(recurse=False)]


class HalfTwin:
    """A bfloat16 copy of a bfloat16 Swin's cast weights
    (``half_cast_params``), which ``at_dtype`` hands the model in place of
    a cast: vitta_tpu's ``params_half`` (vitta_tpu/adapt/engine.py:125-132).
    The copies are autograd leaves; ``grads_to_masters`` upcasts their
    bfloat16 gradients into float32 gradients of the masters, and
    ``refresh`` copies the masters into them after every change of the
    masters.  Each is one foreach call where a cast at every use took a
    launch and an autograd node a tensor: the same values, bit for bit,
    since the cast is the same rounding and each weight has one use a
    forward."""

    def __init__(self, model: nn.Module):
        self.masters = half_cast_params(model)
        self.halves = [p.detach().to(torch.bfloat16).requires_grad_()
                       for p in self.masters]
        self.grads = [torch.zeros_like(p) for p in self.masters]
        for p, h in zip(self.masters, self.halves):
            p.half_twin = h

    def refresh(self):
        with torch.no_grad():
            torch._foreach_copy_(self.halves, self.masters)

    def grads_to_masters(self):
        """The masters' float32 gradients from their copies' (None where a
        copy took no gradient); the copies' gradients are dropped."""
        got = [i for i, h in enumerate(self.halves) if h.grad is not None]
        if got:
            torch._foreach_copy_([self.grads[i] for i in got],
                                 [self.halves[i].grad for i in got])
        for p in self.masters:
            p.grad = None
        for i in got:
            self.masters[i].grad = self.grads[i]
        for h in self.halves:
            h.grad = None

    @staticmethod
    def remove(model: nn.Module):
        """Drop any copies an earlier engine left on ``model``: it casts
        again."""
        for p in half_cast_params(model):
            p.__dict__.pop("half_twin", None)


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
              generator: Optional[torch.Generator],
              samples: Optional[int] = None):
    """Per-sample stochastic depth (timm DropPath semantics,
    vitta_tpu/models/swin.py:257-279): one draw per sample of dim 0
    decides whether its whole residual branch is dropped; the kept ones
    are scaled by 1/keep.  ``samples`` is the true sample count where dim
    0 folds each sample's windows (the window layout, B*nW): one draw per
    sample, repeated over its windows, so that the generator gives the
    same masks as in the spatial layout."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    s = x.shape[0] if samples is None else samples
    mask = torch.rand((s,) + (1,) * x.dim(), generator=generator,
                      device=x.device) < keep
    # (s, windows of a sample, ...): each draw broadcast over its windows
    xs = x.reshape(s, -1, *x.shape[1:])
    return torch.where(mask, xs / keep, torch.zeros(
        (), dtype=x.dtype, device=x.device)).reshape(x.shape)


class WindowAttention3D(nn.Module):
    """Window MSA with 3D relative position bias
    (swin_transformer.py:87-169)."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int, dtype="float32"):
        super().__init__()
        self.dim = dim
        self.dtype = compute_dtype(dtype)
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
        the block resolved for this call: ``"packed"``, ``"heads"`` or
        ``"proj"`` without ``ln``; ``"ln_proj"`` with ``ln`` = (gamma,
        beta, eps) of the preceding LayerNorm (norm1) and ``x``
        un-normalized, and the call then returns (out, y) with y the
        LayerNorm output (vitta_tpu/models/swin.py:188-254)."""
        if (route == "ln_proj") != (ln is not None):
            raise ValueError("route 'ln_proj' and ln=(gamma, beta, eps) go "
                             "together")
        b_, n, c = x.shape
        nh = self.num_heads
        wd, wh, ww = self.window_size
        mask = self._mask(mask_np, mask_key, x.device)
        full = n == wd * wh * ww
        dt = self.dtype
        if full:
            # compact (nh, 2wd-1, hw, hw) for the bfloat16 packed kernels,
            # which read it and collapse its gradient on chip
            # (ops/cuda_attention.py); dense (nh, N, N) otherwise, as
            # vitta_tpu hands its heads and projection-fused kernels the
            # dense form at either dtype (pallas_attention.py:1189-1192,
            # :1238-1243)
            bias = compact_bias(self.relative_position_bias_table,
                                self.window_size)
            if dt != torch.bfloat16 or route != "packed":
                bias = expand_bias(bias, wd)
        wqkv, bqkv = at_dtype(self.qkv.weight, dt), at_dtype(self.qkv.bias, dt)
        wproj = at_dtype(self.proj.weight, dt)
        bproj = at_dtype(self.proj.bias, dt)
        if full and ln is not None:
            return window_attention_ln_proj(
                _contiguous(x), ln[0], ln[1], ln[2], wqkv, bqkv, wproj, bproj,
                bias, mask, self.scale, nh)
        y = x if ln is None else layer_norm(x, *ln)
        if full and route == "proj":
            out = window_attention_proj(_contiguous(y), wqkv, bqkv, wproj,
                                        bproj, bias, mask, self.scale, nh)
            return out if ln is None else (out, y)
        qkv = F.linear(y, wqkv, bqkv)                     # (B_, n, 3C)
        if full and route == "heads":
            # q, k, v as views of the projection output, read where they lie
            q, k, v = qkv.reshape(b_, n, 3, nh, c // nh).unbind(2)
            out = window_attention_heads(q, k, v, bias, mask,
                                         self.scale).reshape(b_, n, c)
        elif full:
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
            q5 = qkv.reshape(b_, n, 3, nh, c // nh).to(torch.float32)
            out = attention_reference(q5[:, :, 0], q5[:, :, 1], q5[:, :, 2],
                                      bias, mask, self.scale).reshape(
                                          b_, n, c).to(dt)
        out = F.linear(out, wproj, bproj)
        return out if ln is None else (out, y)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (swin_transformer.py:48-65); owns the
    parameters only: the block runs them through the MLP op, with or
    without norm2 inside it."""

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
                 attn_route: Optional[str] = None, dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
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
        self.attn = WindowAttention3D(dim, self.window_size, num_heads,
                                      dtype=self.dtype)
        self.norm2 = LayerNorm(dim, f"{tap_prefix}.norm2",
                               stat_types=stat_types)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, taps=None, *, train: bool = False, generator=None,
                wr=None):
        """Spatial form: x (B, D, H, W, C) -> the same shape.

        Window-resident form (``wr`` = (B, (D, H, W), window, shift), from
        ``BasicLayer``): x is already this block's window layout
        (B*nW, N, C) and so is the result; the stage owns the shift and the
        partition, and the block is token-wise ops and the windowed
        attention (vitta_tpu/models/swin.py:403-420).  Parameter and tap
        names are those of the spatial form."""
        if wr is not None:
            return self._window_resident(x, wr, taps, train, generator)
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

    def _window_resident(self, xw, wr, taps, train, generator):
        """The block on its window layout xw (B*nW, N, C): every tap counts
        the B samples, not the windows, and drop-path draws per sample.  No
        padding here (the stage's gate), so ``"ln_proj"`` always fuses."""
        b, (d, h, w), window, shift = wr
        mask_np = compute_shift_mask(d, h, w, window, shift)
        mask_key = (d, h, w, window, shift)
        if self.attn_route == "ln_proj":
            gamma, beta = self.norm1(xw, taps, mode="params")
            attn, ln_out = self.attn(xw, mask_np, mask_key, "ln_proj",
                                     ln=(gamma, beta, self.norm1.eps))
            self.norm1(ln_out, taps, mode="sow_output", stat_count=b)
        else:
            attn = self.attn(self.norm1(xw, taps, stat_count=b), mask_np,
                             mask_key, self.attn_route)
        xw = xw + drop_path(attn, self.drop_path, train, generator, b)
        return self._mlp_tail(xw, taps, train, generator, samples=b)

    def _mlp_tail(self, x, taps, train, generator, samples=None):
        """norm2 and the MLP (vitta_tpu/models/swin.py:422-439).  Where
        ``mlp_ln_fused`` holds norm2 runs inside the MLP op: the module
        still owns the parameters and records both tap sides (the input
        here, the output from the y the op returns), so tap names do not
        move.  Otherwise norm2 is a LayerNorm of its own and the MLP op has
        none.  ``samples``: the true sample count of the window layout."""
        c = x.shape[-1]
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        dt = self.dtype
        if mlp_ln_fused(c, x.numel() // c):
            gamma, beta = self.norm2(x, taps, mode="params")
            y, ln_out = ln_mlp(_contiguous(x), gamma, beta,
                               at_dtype(fc1.weight, dt),
                               at_dtype(fc1.bias, dt),
                               at_dtype(fc2.weight, dt),
                               at_dtype(fc2.bias, dt),
                               self.norm2.eps)
            self.norm2(ln_out, taps, mode="sow_output", stat_count=samples)
        else:
            y = mlp(self.norm2(_contiguous(x), taps, stat_count=samples),
                    at_dtype(fc1.weight, dt), at_dtype(fc1.bias, dt),
                    at_dtype(fc2.weight, dt), at_dtype(fc2.bias, dt))
        return x + drop_path(y, self.drop_path, train, generator, samples)


class PatchMerging(nn.Module):
    """2x2 spatial merge (swin_transformer.py:277-312)."""

    def __init__(self, dim: int, tap_prefix: str,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
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
        return F.linear(self.norm(x, taps),
                        at_dtype(self.reduction.weight, self.dtype))


@functools.lru_cache(maxsize=64)
def window_order(dims: Tuple[int, int, int], window: Tuple[int, int, int],
                 shift: Optional[Tuple[int, int, int]]) -> np.ndarray:
    """The token order of one sample's layout: for each position, its index
    in the (D, H, W) grid in row-major order.  ``shift`` None is the grid
    itself; a shift is the window layout of the grid rolled by -shift, what
    ``torch.roll(x, -shift)`` then ``window_partition`` make.  Cached: treat
    the result as read-only."""
    d, h, w = dims
    grid = np.arange(d * h * w).reshape(d, h, w)
    if shift is None:
        return grid.reshape(-1)
    wd, wh, ww = window
    grid = np.roll(grid, [-s for s in shift], axis=(0, 1, 2))
    return grid.reshape(d // wd, wd, h // wh, wh, w // ww, ww).transpose(
        0, 2, 4, 1, 3, 5).reshape(-1)


def relayout_index(dims, window, src, dst) -> Optional[np.ndarray]:
    """The gather index that takes one sample's tokens from layout ``src``
    to layout ``dst`` (``window_order``'s ``shift``: None for the grid):
    ``out[:, i] = x[:, index[i]]``; None where the two orders are the same.
    A window layout to another is vitta_tpu's ``window_relayout``
    (window_reverse, the net roll, window_partition; models/swin.py:
    468-478) as one permutation."""
    src_order = window_order(dims, window, src)
    to_src = np.empty_like(src_order)
    to_src[src_order] = np.arange(src_order.size)
    index = to_src[window_order(dims, window, dst)]
    return None if np.array_equal(index, np.arange(index.size)) else index


class TokenGather(torch.autograd.Function):
    """``x[:, index]`` on (B, L, C), one gather; its backward is the gather
    of the cotangent by the inverse permutation: both are copies, exact and
    free of atomics (``index_select``'s own backward adds with atomics)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(1, index)

    @staticmethod
    def backward(ctx, g):
        inverse, = ctx.saved_tensors
        return g.index_select(1, inverse), None, None


class BasicLayer(nn.Module):
    """One Swin stage (swin_transformer.py:332-413).

    Under ``VITTA_WINDOW_RESIDENT`` (read here, once) a stage whose taps
    are spatiotemp alone, and whose dims all divide by the (clamped)
    window, keeps its activations in window layout from block to block
    (vitta_tpu/models/swin.py:517-553): one gather into the layout of block
    0, one where the shift changes, one back to the grid at exit, each a
    permutation of the tokens (``relayout_index``, ``TokenGather``; its
    index made once per shape and device), in place of the spatial form's
    roll, partition, reverse and roll around every block.  Every op in the
    blocks is token-wise or windowed, and the spatiotemp statistics do not
    depend on the tokens' order.  Any other stage takes the spatial form."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size,
                 drop_paths, downsample: bool, tap_prefix: str,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 attn_route: Optional[str] = None, dtype="float32"):
        super().__init__()
        self.window_size = tuple(window_size)
        # the window layout scrambles the (D, H, W) structure that every
        # statistic but spatiotemp reads
        self.window_resident = (window_resident_enabled()
                                and tuple(stat_types) == ("spatiotemp",))
        self._gathers = {}
        shift = tuple(s // 2 for s in window_size)
        self.blocks = nn.ModuleList([
            SwinBlock3D(dim, num_heads, f"{tap_prefix}.blocks_{i}",
                        window_size=window_size,
                        shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                        drop_path=drop_paths[i], stat_types=stat_types,
                        attn_route=attn_route, dtype=dtype)
            for i in range(depth)])
        self.downsample = PatchMerging(
            dim, f"{tap_prefix}.downsample", stat_types=stat_types,
            dtype=dtype) if downsample else None

    def forward(self, x, taps=None, *, train: bool = False, generator=None):
        if self.window_resident_ok(x.shape):
            x = self._forward_window_resident(x, taps, train, generator)
        else:
            for blk in self.blocks:
                x = blk(x, taps, train=train, generator=generator)
        if self.downsample is not None:
            x = self.downsample(x, taps)
        return x

    def window_resident_ok(self, shape) -> bool:
        """Whether an input of ``shape`` (B, D, H, W, C) takes the window
        layout: the flag and the taps allow it and no dim needs padding."""
        if not self.window_resident:
            return False
        dims = tuple(shape[1:4])
        window = get_window_size(dims, self.window_size)
        return all(n % k == 0 for n, k in zip(dims, window))

    def _relayout(self, x, dims, window, src, dst):
        """x (B, L, C) from layout ``src`` to ``dst`` (``relayout_index``)."""
        key = (dims, window, src, dst, str(x.device))
        if key not in self._gathers:
            index = relayout_index(dims, window, src, dst)
            self._gathers[key] = None if index is None else (
                torch.from_numpy(index).to(x.device),
                torch.from_numpy(np.argsort(index)).to(x.device))
        pair = self._gathers[key]
        return x if pair is None else TokenGather.apply(x, *pair)

    def _forward_window_resident(self, x, taps, train, generator):
        b, d, h, w, c = x.shape
        dims = (d, h, w)
        window, base_shift = get_window_size(
            dims, self.window_size, tuple(s // 2 for s in self.window_size))
        n = window[0] * window[1] * window[2]
        cur = (0, 0, 0)
        xw = self._relayout(x.reshape(b, -1, c), dims, window, None, cur)
        for i, blk in enumerate(self.blocks):
            shift = (0, 0, 0) if i % 2 == 0 else base_shift
            if shift != cur:
                xw = self._relayout(xw, dims, window, cur, shift)
                cur = shift
            xw = blk(xw.reshape(-1, n, c), taps, train=train,
                     generator=generator,
                     wr=(b, dims, window, shift)).reshape(b, -1, c)
        counters.window_resident_stages += 1
        return self._relayout(xw, dims, window, cur, None).reshape(
            b, d, h, w, c)


def patchify_mm(x, patch_size):
    """(B, T, H, W, c) -> (B, T/pd, H/ph, W/pw, c*pd*ph*pw), each patch in
    (c, t, h, w) order (vitta_tpu/models/swin.py:574-590): the row order of
    the Conv3d weight (C, c, pd, ph, pw) flattened, which vitta_tpu's
    ``kernel_mm`` makes of its (pd, ph, pw, c, C) kernel."""
    pd, ph, pw = patch_size
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // pd, pd, h // ph, ph, w // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, t // pd, h // ph, w // pw, c * pd * ph * pw)


class PatchEmbed3D(nn.Module):
    """Conv3d patchify + LayerNorm without a tap
    (swin_transformer.py:416-456).

    Under ``VITTA_PATCHIFY_V2`` (read here, once) an input whose T, H and W
    divide by the patch is embedded as ``patchify_mm`` times the Conv3d
    weight flattened, (C, 3*pd*ph*pw), with no convolution
    (vitta_tpu/models/swin.py:650-660).  The parameters stay the
    Conv3d's.  At bfloat16 ``F.linear`` sums the product and the bias in
    float32 and rounds once, where ``F.conv3d`` rounds them and where XLA
    does with its excess precision on; vitta_tpu's program as written
    rounds the product before it adds the bias.  At float32 on the card the
    two forms follow different switches: the Conv3d runs in TF32 under
    ``torch.backends.cudnn.allow_tf32`` (PyTorch's default: on), the
    product under ``torch.backends.cuda.matmul.allow_tf32`` (default:
    off)."""

    def __init__(self, patch_size, embed_dim: int, tap_prefix: str,
                 dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(3, embed_dim, kernel_size=self.patch_size,
                              stride=self.patch_size)
        self.patchify_v2 = patchify_v2_enabled()
        self.norm = LayerNorm(embed_dim, f"{tap_prefix}.patch_embed_norm",
                              tap=False)

    def forward(self, x):
        """(B, T, H, W, 3) -> (B, D, H', W', C)."""
        pd, ph, pw = self.patch_size
        t, h, w = x.shape[1:4]
        dt = self.dtype
        weight = at_dtype(self.proj.weight, dt)          # (C, 3, pd, ph, pw)
        bias = at_dtype(self.proj.bias, dt)
        if t % pd or h % ph or w % pw:
            x = F.pad(x, (0, 0, 0, (-w) % pw, 0, (-h) % ph, 0, (-t) % pd))
        elif self.patchify_v2:
            x = F.linear(patchify_mm(x.to(dt), self.patch_size),
                         weight.reshape(weight.shape[0], -1), bias)
            return self.norm(x)
        # the permuted view of a channels-last clip is channels_last_3d
        # memory, which the convolution takes and returns as is; then the
        # view back is contiguous and ``contiguous`` is free.  The clip and
        # the weights at the compute dtype
        x = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), weight, bias,
                     self.proj.stride).permute(0, 2, 3, 4, 1)
        return self.norm(_contiguous(x))


class SwinTransformer3D(nn.Module):
    """Swin-B video backbone (swin_transformer.py:459-661)."""

    def __init__(self, patch_size=(2, 4, 4), embed_dim: int = 128,
                 depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                 window_size=(8, 7, 7), drop_path_rate: float = 0.2,
                 stat_types: Tuple[str, ...] = ("spatiotemp",),
                 tap_prefix: str = "backbone",
                 attn_route: Optional[str] = None, dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.patch_embed = PatchEmbed3D(patch_size, embed_dim, tap_prefix,
                                        dtype=dtype)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        layers, i0 = [], 0
        for li, depth in enumerate(depths):
            layers.append(BasicLayer(
                embed_dim * 2 ** li, depth, num_heads[li], tuple(window_size),
                tuple(dpr[i0:i0 + depth]), li < len(depths) - 1,
                f"{tap_prefix}.layers_{li}", stat_types=stat_types,
                attn_route=attn_route, dtype=dtype))
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
        # pooled in float32 at either compute dtype, without a float32 copy
        x = torch.mean(x, dim=(1, 2, 3), dtype=torch.float32)    # (B, C)
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
                 attn_route: Optional[str] = None, dtype="float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = SwinTransformer3D(
            patch_size=patch_size, embed_dim=embed_dim, depths=depths,
            num_heads=num_heads, window_size=window_size,
            drop_path_rate=drop_path_rate, stat_types=tuple(stat_types),
            attn_route=attn_route, dtype=dtype)
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
        return torch.mean(feats, dim=(1, 2, 3), dtype=torch.float32)
