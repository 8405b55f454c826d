"""One place that decides where JAX keeps its persistent compilation cache.

The bench, `chip_smoke.py`, the tests and the `prof/` scripts call
`enable_compile_cache()` before their first compile.  If
`JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing else is
set.  Otherwise the cache lives at a fixed directory inside the checkout
(`.jax_cache`, listed in `.gitignore`): the path is part of the cache key, so
a directory that moved from run to run would never hit.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on (see module doc); returns its directory."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
