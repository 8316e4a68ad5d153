"""One persistent compilation cache for every entry point.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
else is configured.  Otherwise the cache lives at a fixed path inside the
checkout, `<checkout>/.jax_cache`: the path is part of the cache key, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at CACHE_DIR, unless
    JAX_COMPILATION_CACHE_DIR already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
