"""Persistent JAX compile cache for the programs that drive the device.

``chip_smoke.py``, ``bench.py`` and the CLI's device commands call
``configure_compile_cache`` before their first compile.  The library itself
sets nothing at import.
"""

from __future__ import annotations

import os

# The checkout root: the directory that holds the ``minlz_jax`` package.
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def configure_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is set here).  Otherwise point JAX's persistent
    cache at ``<checkout>/.jax_cache``: a fixed path, since the path is
    part of what a later process must find again.  Returns the directory
    in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
