"""Persistent JAX compilation cache, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and this
module sets nothing. Otherwise the cache lives at a fixed ``.jax_cache``
directory at the root of the checkout, where the next run of the same
checkout finds it.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Initializes no backend."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
