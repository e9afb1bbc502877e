"""Persistent compilation cache, shared by every entry point.

Compiling a frame takes seconds to minutes; the cache makes the second run
of the same shapes start at once. Entry points (render.py, bench.py,
viewer.py, chip_smoke.py) call `enable_compile_cache()` before their first
compile.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set
    (JAX reads it itself), else `<repo>/.jax_cache`."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the cache on; returns its directory. Sets no directory in code
    when the environment names one."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
