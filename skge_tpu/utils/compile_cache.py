"""Persistent XLA compilation cache at a fixed place.

JAX keys its persistent cache on the program and the cache path, so the
directory must not move between runs. `JAX_COMPILATION_CACHE_DIR`, when
set, is JAX's own setting and wins; otherwise programs are cached under
`<checkout>/.jax_cache` (listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory. Call before the
    first compilation: JAX fixes the cache when it first compiles."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
