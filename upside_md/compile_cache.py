"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

# the checkout root: the directory that holds the package
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache at a fixed directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this sets
    nothing.  Otherwise the cache goes to `.jax_cache/` at the checkout
    root (listed in .gitignore): the directory is part of the cache key,
    so it must not move between runs.  Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
