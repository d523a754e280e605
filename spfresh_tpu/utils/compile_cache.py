"""Where JAX keeps its persistent compilation cache.

Every entry script (``bench.py``, ``chip_smoke.py``, ``examples/``,
``benchmarks/``, the test harness) calls :func:`enable_compile_cache` once,
before its first compile.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing else is set.  Otherwise the cache goes to the
fixed in-checkout path ``<repo>/.jax_cache`` (listed in ``.gitignore``): the
path is part of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
