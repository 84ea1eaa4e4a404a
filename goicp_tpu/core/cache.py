"""Persistent XLA compilation cache.

A cold process compiles every round shape, kernel and ICP batch it meets;
JAX's on-disk executable cache lets every later process start warm (the
reference pays nothing comparable: nvcc compiles at build time).

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and nothing here overrides it), otherwise a fixed
``.jax_cache`` directory inside the checkout — a fixed path, because the
path is part of what a later process must find again.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
_enabled = False


def cache_dir() -> str:
    """The directory the persistent cache uses (see the module docs)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT_CACHE_DIR
    )


def enable_persistent_cache() -> str:
    """Turn the persistent cache on (idempotent); returns its directory."""
    global _enabled
    path = cache_dir()
    if _enabled:
        return path
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
    return path
