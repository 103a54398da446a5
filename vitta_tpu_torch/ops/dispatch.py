"""The environment flags that choose Video Swin's attention route.

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

There is no flag that turns a kernel off: on a CUDA tensor every route runs
hand-written kernels.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

ATTN_ROUTES = ("packed", "proj", "ln_proj")


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
    ``VITTA_ATTN_PROJ_FUSED`` says as its fallback, else that alone."""
    if attn_route is None:
        fallback = "proj" if attn_proj_fused_enabled() else "packed"
        return ("ln_proj" if attn_ln_enabled() else fallback), fallback
    if attn_route not in ATTN_ROUTES:
        raise ValueError(f"attn_route must be None or one of {ATTN_ROUTES}, "
                         f"got {attn_route!r}")
    return attn_route, "proj" if attn_route == "ln_proj" else attn_route
