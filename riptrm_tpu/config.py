"""Runtime configuration helpers.

The reference protocol needs float64 (tolerances to 1e-16; SURVEY.md §6),
and every entry point shares one persistent compilation cache.  ``setup()``
bundles both, plus an optional pin to the CPU backend for host parity runs.
"""

from __future__ import annotations

import os
import pathlib

# Fixed path inside the checkout: the cache directory is part of the cache
# key, so a path that moves between runs never hits.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this sets
    nothing.  Otherwise the cache lives at ``<repo>/.jax_cache``.  Returns
    the directory this call configured, or None when the environment
    decides.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return str(DEFAULT_CACHE_DIR)


def setup(cpu: bool = False, x64: bool = True):
    """Configure JAX for a run: the default device (the GPU where one is
    present) unless ``cpu``, float64 if ``x64``, and the compile cache.

    Call before any JAX computation.
    """
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    return jax
