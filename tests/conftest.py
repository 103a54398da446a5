"""Test configuration: force CPU with 8 virtual devices so multi-chip
sharding paths are exercised without TPU hardware (SURVEY.md §4).

Also enables the JAX persistent compilation cache (the suite is
compile-bound on a 1-core host: test_engine.py alone is minutes of XLA
compiles without it) and registers the ``slow`` marker so the default
verification loop can run ``pytest -m 'not slow'`` quickly.
"""

import os

# VITTA_TEST_TPU=1 lifts the CPU pin so the TPU-gated kernel tests
# (test_tpu_kernels.py) run on real hardware.
_USE_TPU = os.environ.get("VITTA_TEST_TPU", "") == "1"
if not _USE_TPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# A plugin may have imported jax before this conftest ran, in which case
# jax captured JAX_PLATFORMS at import time — override via config too.
import jax  # noqa: E402

if not _USE_TPU:
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: repeated suite runs skip recompiles.
_CACHE_DIR = os.environ.get("VITTA_JAX_CACHE",
                            os.path.expanduser("~/.cache/vitta_jax_cache"))
os.makedirs(_CACHE_DIR, exist_ok=True)
jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: compile-heavy tests (full engine/oracle parity); "
        "deselect with -m 'not slow' for the quick loop")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() "
        "is false")
