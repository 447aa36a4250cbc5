"""Where JAX keeps its persistent compilation cache."""

import os

import jax

# fixed, so that a later process on the same checkout finds what an
# earlier one compiled (the directory is part of the cache's key)
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself
    and nothing is set here.  Otherwise the cache is ``.jax_cache`` at
    the root of the checkout.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
