"""Where JAX keeps its persistent compilation cache.

`enable()` is called by every entry point (CLI, benchmarks, examples,
chip_smoke.py).  When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
and nothing is set here.  Otherwise the cache goes to a fixed `.jax_cache/`
directory at the root of the checkout (listed in .gitignore): the path is
part of the cache key, so a directory that moves never hits.
"""
from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
