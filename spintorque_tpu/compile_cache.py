"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing here
changes. Otherwise the cache lives at a fixed ``<repo>/.jax_cache``: the
path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    """The cache directory this process uses (the rule above)."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
