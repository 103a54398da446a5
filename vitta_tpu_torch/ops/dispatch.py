"""What chooses Video Swin's attention route, its MLP form and its layout
variants.

The port's own copy of what it needs from vitta_tpu/ops/dispatch.py: the
same environment names with the same tri-state (unset or empty -> the
default; ``0`` / ``false`` / ``off`` -> off; anything else -> on).  Both
routes are math-identical alternatives to the default packed route and are
default-off:

* ``VITTA_ATTN_PROJ_FUSED=1``: the qkv and output projections run inside
  the attention op (ops/cuda_attention_proj.py, ``window_attention_proj``);
  ``VITTA_ATTN_NO_PROJ`` (set to anything non-empty) forces it off again.
* ``VITTA_ATTN_LN=1``: norm1 moves into that op's prologue as well
  (``window_attention_ln_proj``), in every block that can take it.

A fourth route, ``"heads"``, is the per-(head, window) attention on
separate q, k, v (ops/cuda_attention.py, ``window_attention_heads``), which
vitta_tpu takes only where its packed kernel does not fit its fast memory.
That trigger means nothing on a GPU and vitta_tpu has no flag for the
route, so only an explicit ``attn_route="heads"`` selects it here.

``mlp_ln_fused`` is the port's copy of the shape rule by which a Video Swin
block fuses norm2 into its MLP op or runs the two apart
(vitta_tpu/models/swin.py:428).

There is no flag that turns a kernel off: on a CUDA tensor every route runs
hand-written kernels.

The layout variants of Video Swin, the same names and tri-state as
vitta_tpu/ops/dispatch.py:43-166, each read once where the module that
takes it is built:

* ``VITTA_WINDOW_RESIDENT``: a stage keeps its activations in window layout
  from block to block (models/swin.py:BasicLayer), one gather at entry, at
  each change of shift and at exit in place of a roll, a partition, a
  reverse and a roll around every block;
* ``VITTA_PATCHIFY_V2``: the patch embedding as an unfold in (c, t, h, w)
  order times the flattened Conv3d weight (``patchify_mm``).

vitta_tpu turns both on by default: those defaults are ms/video of its TPU
sweeps (its :10-33), which say nothing of the H100.  Here both are off by
default, so the default path is the one the port has run since it began
(per-block roll and partition, the Conv3d); a PR judged on the benchmark's
cells may flip one.  Each is the same math as the default, held so by
tests/test_torch_swin_layouts.py.

vitta_tpu's other flags have no counterpart: ``VITTA_ATTN_PIPE`` and
``VITTA_MLP_PIPE`` order the work inside its Pallas kernels (the port's
kernels have their own schedules); ``VITTA_DISABLE_PALLAS`` turns its
kernels off, and the port has no such switch; ``VITTA_JAX_CACHE`` and
``VITTA_NO_COMPILE_CACHE`` steer JAX's compile cache; ``VITTA_NO_HALF_TWIN``
is the default of an argument the port's engine takes as it is
(``VittaEngine(half_twin=False)``); ``VITTA_PATCHIFY``, the engine's unfold
of the uint8 frames before it normalises them, is off in vitta_tpu too, and
no caller of the port needs a second unfolded form beside
``VITTA_PATCHIFY_V2``'s; ``VITTA_COMPACT_BIAS`` (the float32 packed
attention on the compact bias) made a float32 Swin-B step on the H100
0.7-1.2 ms busier than the bias expansion and collapse it saves, and the
compact bias that vitta_tpu takes by itself where the dense one overflows
the TPU's scoped memory (pallas_attention.py:328) answers a limit the H100
does not have.  The bfloat16 packed attention takes the compact bias
always.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

ATTN_ROUTES = ("packed", "proj", "ln_proj", "heads")


def flag_enabled(name: str, default: bool) -> bool:
    """Tri-state env gate: unset/empty -> default; 0/false/off -> False;
    anything else -> True."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false", "off")


def attn_ln_enabled() -> bool:
    """Fuse the pre-attention LayerNorm (norm1) into the projection-fused
    window attention.  Default off."""
    return flag_enabled("VITTA_ATTN_LN", False)


def attn_proj_fused_enabled() -> bool:
    """Fuse the qkv and output projections into the window attention op.
    Default off (the packed route); ``VITTA_ATTN_NO_PROJ`` forces it off."""
    if os.environ.get("VITTA_ATTN_NO_PROJ"):
        return False
    return flag_enabled("VITTA_ATTN_PROJ_FUSED", False)


def resolve_attn_route(attn_route: Optional[str] = None) -> Tuple[str, str]:
    """(route, fallback) of a Video Swin block, each one of ``ATTN_ROUTES``.

    ``route`` is what the block takes; ``fallback`` is what a block that
    cannot take ``"ln_proj"`` (it pads, or a tap other than spatiotemp
    reads y) takes instead.  An explicit ``attn_route`` reads nothing of
    the environment: ``"ln_proj"`` falls back to ``"proj"``.  Only
    ``attn_route=None`` reads the flags, as vitta_tpu does:
    ``VITTA_ATTN_LN`` gives ``"ln_proj"`` with whatever
    ``VITTA_ATTN_PROJ_FUSED`` says as its fallback, else that alone;
    the flags never give ``"heads"``."""
    if attn_route is None:
        fallback = "proj" if attn_proj_fused_enabled() else "packed"
        return ("ln_proj" if attn_ln_enabled() else fallback), fallback
    if attn_route not in ATTN_ROUTES:
        raise ValueError(f"attn_route must be None or one of {ATTN_ROUTES}, "
                         f"got {attn_route!r}")
    return attn_route, "proj" if attn_route == "ln_proj" else attn_route


def mlp_ln_fused(c: int, tokens: int) -> bool:
    """Whether a Video Swin block of width ``c`` over ``tokens`` tokens
    runs norm2 inside its MLP op (ops/cuda_mlp.py, ``ln_mlp``) or as a
    LayerNorm of its own followed by ``mlp``.  The rule is vitta_tpu's
    (models/swin.py:428: whole tiles of 128 lanes and 8 sublanes),
    mirrored and not re-tuned, so that every width takes the same two ops
    in both packages: Swin-B's 128 to 1024 fuse, Swin-T's and Swin-S's 96
    and 192 do not."""
    return c % 128 == 0 and tokens % 8 == 0


def window_resident_enabled() -> bool:
    """Video Swin stages keep their activations in window layout
    (``VITTA_WINDOW_RESIDENT``).  Default off."""
    return flag_enabled("VITTA_WINDOW_RESIDENT", False)


def patchify_v2_enabled() -> bool:
    """The patch embedding as ``patchify_mm`` times the flattened Conv3d
    weight (``VITTA_PATCHIFY_V2``).  Default off."""
    return flag_enabled("VITTA_PATCHIFY_V2", False)

