"""Persistent XLA compilation cache.

The aligner dispatches a small, fixed family of bucketed shapes, so
keeping compiled executables across runs (and across the builder,
aligner and bench entry points) lets every run after the first skip
most compilation. The reference has no analog: its CUDA kernels are
compiled at build time.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at the fixed path
``<checkout>/.jaxcache`` (gitignored): a fixed path lets every run of a
checkout find what an earlier run compiled. JAX's own thresholds decide
what is worth persisting.
"""

from __future__ import annotations

import os
import sys

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_enabled = False


def cache_dir() -> str | None:
    """The directory this module sets, or None when the environment
    names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jaxcache")


def enable_persistent_cache() -> None:
    global _enabled
    if _enabled:
        return
    path = cache_dir()
    if path is not None:
        import jax

        try:
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        except OSError as e:  # the cache is an optimization, never fatal
            print(f"[soap3dp] compilation cache disabled: {e}",
                  file=sys.stderr)
    _enabled = True
