"""Persistent XLA compilation cache, shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
sets no other path. Otherwise the cache lives at the fixed path
``<checkout>/.cache/xla``: the path is part of the cache key, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".cache", "xla")


def enable():
    """Turn the cache on; returns the directory it uses."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return path
