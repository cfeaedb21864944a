"""Where JAX keeps its persistent compilation cache.

Called once at start-up by the entry points (``fenix_tpu.launch``,
``chip_smoke.py``, ``bench.py``). If ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing is set here. Otherwise the cache
lives at ``<checkout>/.jax_cache``: a fixed path, because the path is
part of what a later process must find again.
"""

from __future__ import annotations

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns it."""
    env = os.environ.get(_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
