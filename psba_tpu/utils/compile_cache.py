"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, chip_smoke.py, the benchmark
scripts): when `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and
nothing is set here; otherwise the cache lives in `<repo>/.jax_cache`. The
path is fixed because it is part of the cache key — a directory that moves
between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
