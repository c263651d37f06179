"""Persistent XLA compilation-cache activation.

Kernel compiles cost seconds per shape and amortize across processes
only through jax's persistent compilation cache. The cache lives in
exactly one directory:

  * JAX_COMPILATION_CACHE_DIR when it is set — used as given, and no
    other directory is set in code;
  * otherwise `.jax_cache/` at the root of the checkout (derived from
    this package's location, listed in .gitignore), the same path on
    every call, so repeat runs from one checkout hit the same entries.

Activation goes through jax.config.update after import: an environment
that imports jax before user code runs would otherwise freeze the
config default before the variable is read. Called from package import
(vstrains_tpu/__init__.py), pipeline.run and prewarm, all idempotently.
"""

from __future__ import annotations

import logging
import os

_LOG = logging.getLogger("vstrains_tpu.jaxcache")

# <checkout>/.jax_cache: two levels up from vstrains_tpu/utils/
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache(logger: logging.Logger = None) -> str:
    """Point jax's persistent compilation cache at cache_dir(), creating
    the directory. Safe to call any number of times; returns the cache
    dir, or "" when the update fails."""
    logger = logger or _LOG
    try:
        import jax
        path = cache_dir()
        os.makedirs(path, exist_ok=True)
        if jax.config.jax_compilation_cache_dir != path:
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", 1.0)
        return path
    except Exception as e:  # non-fatal: slower, never wrong
        logger.debug("persistent compilation cache unavailable: %s", e)
        return ""
