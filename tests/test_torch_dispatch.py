"""The port's attention-route flags (vitta_tpu_torch/ops/dispatch.py): the
same environment names and the same tri-state as vitta_tpu/ops/dispatch.py
(tests/test_dispatch_flags.py), and what ``attn_route=None`` makes of them.
"""

import pytest
import torch

from vitta_tpu.ops import dispatch as jax_dispatch
from vitta_tpu_torch.models.swin import Recognizer3D, SwinBlock3D
from vitta_tpu_torch.ops import dispatch

torch.set_num_threads(1)

FLAGS = ("VITTA_ATTN_LN", "VITTA_ATTN_PROJ_FUSED", "VITTA_ATTN_NO_PROJ")
GATES = [
    # (fn, the JAX package's, env var, default)
    (dispatch.attn_ln_enabled, jax_dispatch.attn_ln_enabled,
     "VITTA_ATTN_LN", False),
    (dispatch.attn_proj_fused_enabled, jax_dispatch.attn_proj_fused_enabled,
     "VITTA_ATTN_PROJ_FUSED", False),
]


@pytest.fixture
def clean_env(monkeypatch):
    for var in FLAGS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("fn,jax_fn,var,default", GATES,
                         ids=[g[2] for g in GATES])
def test_tristate(fn, jax_fn, var, default, clean_env):
    assert fn() is default and jax_fn() is default
    clean_env.setenv(var, "")
    assert fn() is default
    for off in ("0", "false", "off", "OFF"):
        clean_env.setenv(var, off)
        assert fn() is False and jax_fn() is False
    for on in ("1", "true", "yes"):
        clean_env.setenv(var, on)
        assert fn() is True and jax_fn() is True


@pytest.mark.parametrize("value,default,want", [
    (None, True, True), (None, False, False), ("", True, True),
    ("0", True, False), ("Off", True, False), ("2", False, True)])
def test_flag_enabled(value, default, want, clean_env):
    if value is not None:
        clean_env.setenv("VITTA_SOME_FLAG", value)
    else:
        clean_env.delenv("VITTA_SOME_FLAG", raising=False)
    assert dispatch.flag_enabled("VITTA_SOME_FLAG", default) is want
    assert jax_dispatch.flag_enabled("VITTA_SOME_FLAG", default) is want


def test_legacy_no_proj_forces_packed(clean_env):
    """VITTA_ATTN_NO_PROJ=1 overrides even an explicit PROJ_FUSED=1."""
    clean_env.setenv("VITTA_ATTN_PROJ_FUSED", "1")
    assert dispatch.attn_proj_fused_enabled() is True
    clean_env.setenv("VITTA_ATTN_NO_PROJ", "1")
    assert dispatch.attn_proj_fused_enabled() is False
    assert jax_dispatch.attn_proj_fused_enabled() is False
    assert dispatch.resolve_attn_route(None) == ("packed", "packed")


@pytest.mark.parametrize("env,want", [
    ({}, ("packed", "packed")),
    ({"VITTA_ATTN_PROJ_FUSED": "1"}, ("proj", "proj")),
    ({"VITTA_ATTN_LN": "1"}, ("ln_proj", "packed")),
    ({"VITTA_ATTN_LN": "1", "VITTA_ATTN_PROJ_FUSED": "1"},
     ("ln_proj", "proj")),
    ({"VITTA_ATTN_LN": "0", "VITTA_ATTN_PROJ_FUSED": "off"},
     ("packed", "packed")),
    ({"VITTA_ATTN_LN": "1", "VITTA_ATTN_PROJ_FUSED": "1",
      "VITTA_ATTN_NO_PROJ": "1"}, ("ln_proj", "packed")),
])
def test_route_from_the_environment(env, want, clean_env):
    for var, value in env.items():
        clean_env.setenv(var, value)
    assert dispatch.resolve_attn_route(None) == want
    block = SwinBlock3D(8, 2, "b", window_size=(2, 3, 3))
    assert (block.attn_route, block.attn_fallback) == want


@pytest.mark.parametrize("route", dispatch.ATTN_ROUTES)
def test_an_explicit_route_wins_over_the_environment(route, clean_env):
    clean_env.setenv("VITTA_ATTN_LN", "1" if route != "ln_proj" else "0")
    clean_env.setenv("VITTA_ATTN_PROJ_FUSED", "1" if route == "packed" else "0")
    assert dispatch.resolve_attn_route(route) == (
        route, "proj" if route == "ln_proj" else route)
    model = Recognizer3D(4, window_size=(2, 3, 3), embed_dim=8,
                         depths=(1, 1), num_heads=(1, 2), attn_route=route)
    assert [b.attn_route for layer in model.backbone.layers
            for b in layer.blocks] == [route, route]


def test_route_is_resolved_at_construction(clean_env):
    clean_env.setenv("VITTA_ATTN_PROJ_FUSED", "1")
    block = SwinBlock3D(8, 2, "b", window_size=(2, 3, 3))
    clean_env.delenv("VITTA_ATTN_PROJ_FUSED")
    assert block.attn_route == "proj"
    assert SwinBlock3D(8, 2, "b", window_size=(2, 3, 3)).attn_route == "packed"


def test_an_unknown_route_raises():
    with pytest.raises(ValueError, match="attn_route"):
        dispatch.resolve_attn_route("fused")
    with pytest.raises(ValueError, match="attn_route"):
        SwinBlock3D(8, 2, "b", window_size=(2, 3, 3), attn_route="ln")
    attn = SwinBlock3D(8, 2, "b", window_size=(2, 3, 3)).attn
    with pytest.raises(ValueError, match="ln_proj"):
        attn(torch.zeros(1, 18, 8), route="ln_proj")


def test_a_tap_other_than_spatiotemp_takes_the_fallback(clean_env):
    """y comes back in window layout, which only the token-order-invariant
    spatiotemp statistic may read."""
    kw = dict(window_size=(2, 3, 3), embed_dim=8, depths=(1,), num_heads=(2,))
    def route(**model_kw):
        model = Recognizer3D(4, **model_kw, **kw)
        return model.backbone.layers[0].blocks[0].attn_route

    # an explicit route reads nothing of the environment
    clean_env.setenv("VITTA_ATTN_NO_PROJ", "1")
    assert route(stat_types=("spatiotemp", "temp"),
                 attn_route="ln_proj") == "proj"
    assert route(attn_route="ln_proj") == "ln_proj"
    clean_env.delenv("VITTA_ATTN_NO_PROJ")
    # None takes the fallback the flags name
    clean_env.setenv("VITTA_ATTN_LN", "1")
    assert route(stat_types=("temp",)) == "packed"
    clean_env.setenv("VITTA_ATTN_PROJ_FUSED", "1")
    assert route(stat_types=("temp",)) == "proj"
    assert route() == "ln_proj"
