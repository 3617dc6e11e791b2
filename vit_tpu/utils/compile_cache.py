"""JAX's persistent compilation cache, in one place for every entry point.

A compiled B/16 forward takes tens of seconds to build; the cache keeps it
across processes. Its directory is part of what makes a hit, so it must not
move between runs:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else is
  set here.
- otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

#: The checkout's own cache directory (the repository root, next to
#: ``vit_tpu/``).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
