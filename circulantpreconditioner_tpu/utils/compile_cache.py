"""Persistent XLA compilation cache placement.

JAX keys its persistent cache by path, so the cache lives at one fixed place:
`$JAX_COMPILATION_CACHE_DIR` when it is set, and otherwise `.jax_cache/` at
the root of the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at $JAX_COMPILATION_CACHE_DIR
    or DEFAULT_CACHE_DIR and return that directory. Safe to call repeatedly."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
