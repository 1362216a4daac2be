"""Where JAX's persistent compilation cache lives.

One helper for every entry point that compiles big programs (chip_smoke.py,
bench.py, ``python -m srack_tpu``).  If ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and nothing is set in code.  Otherwise the cache sits at
one fixed directory inside the checkout (``.jax_cache/``, git-ignored): the
path is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
