"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding
path (`walnuts_tpu.parallel`) is exercised without accelerators.  Env
vars must be set before jax imports.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from walnuts_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the full suite compiles ~400 XLA CPU
# programs in one process, and this jaxlib's CPU backend intermittently
# segfaults inside backend_compile_and_load after ~100 tests (observed
# at different tests on different runs; every file passes standalone).
# With the cache, reruns load executables from disk instead of
# recompiling, which removes almost the entire crash window.  If a
# cold-cache run does crash, simply rerun — completed compiles are
# already cached.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
