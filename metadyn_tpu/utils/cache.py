"""Persistent compile-cache policy.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; it is used as
  is and no other path is set.
- Unset, on the GPU: ``<repo>/.jax_cache``, a fixed path (the path is
  part of the cache key, so a directory that moves never hits).
- Unset, on any other platform: no persistent cache.  The CPU test
  suite is trace-bound, and reloading cached XLA:CPU executables of the
  8-virtual-device shard_map programs crashed (same-host reload of a
  multi-device AOT executable).
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(backend: str, environ=os.environ) -> Optional[str]:
    """The cache directory the policy picks for ``backend``, or None."""
    if environ.get(ENV):
        return environ[ENV]
    if backend == "gpu":
        return str(REPO_CACHE)
    return None


def _backend() -> str:
    """The backend JAX will use.  An explicit CPU selection is read from
    the config without initializing any backend (so callers can still
    set the CPU device count afterwards)."""
    import jax

    plats = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    first = plats.split(",")[0].strip().lower()
    return first if first == "cpu" else jax.default_backend()


def enable_persistent_cache(min_compile_secs: float = 2.0) -> Optional[str]:
    """Apply the cache policy for the selected backend and return the
    directory in use (None: no persistent cache).

    Must run before the first compile: JAX latches its cache decision at
    first use."""
    import jax

    path = cache_dir(_backend())
    if path is not None and not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
