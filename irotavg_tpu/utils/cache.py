"""Persistent XLA compilation cache.

The pipeline compiles a handful of large programs (ORB extractor per image
shape, matcher per capacity, solver per padding bucket).  First compiles
cost tens of seconds; JAX's persistent compilation cache makes every later
process start warm.  Applied by the CLIs at startup; opt out with
``IROTAVG_NO_CACHE=1``.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at the fixed path
``<repo>/.jax_cache``: the directory is part of the cache key, so a path
that moved between runs would never hit.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str | None:
    """Turn on JAX's on-disk compilation cache. Returns the dir used."""
    if os.environ.get("IROTAVG_NO_CACHE"):
        return None
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
