"""Persistent XLA compilation cache placement.

A cold solve compiles the chunked LM program once per shape, which takes
tens of seconds; the persistent cache lets a later process skip that.
The cache's key includes its path, so it lives at a fixed place.
"""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it.

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads that directory
    and nothing else is configured; otherwise the cache goes to
    DEFAULT_DIR inside the checkout.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
