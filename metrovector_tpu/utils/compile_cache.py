"""Persistent XLA compilation cache wiring.

JAX ships a persistent on-disk compilation cache keyed by HLO hash — wiring
it means the SECOND process that compiles an identical (shape, config)
search program loads the serialized executable in seconds instead of
recompiling.

Reference analog: none — the reference has no compiler in the loop at all
(its open is a ~10 ms mmap, ``README.md:146``).

Opt-in for library users (call :func:`enable_compilation_cache`), on for
the repo's own entry points (CLI, ``bench.py``, ``benchmarks/``,
``chip_smoke.py``). The directory is ``$JAX_COMPILATION_CACHE_DIR`` when
that is set — no other directory is configured then — else the fixed
``<checkout>/.jax_cache`` (git-ignored), so nothing is written outside the
checkout.
"""

from __future__ import annotations

import os

#: fallback cache directory: ``.jax_cache`` at the root of the checkout
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else
    :data:`CHECKOUT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and relax the entry thresholds so even
    small search programs are cached. Safe to call more than once and
    before or after backend initialization. Returns the directory in
    use."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    if prev is not None and prev != cache_dir:
        # JAX initializes its on-disk cache singleton at most once per
        # process (at the first cache-enabled compile); re-pointing the
        # config after that silently keeps writing to the OLD directory
        # unless the singleton is reset.
        try:
            from jax.experimental.compilation_cache import (
                compilation_cache as _cc,
            )

            _cc.reset_cache()
        except (ImportError, AttributeError):  # API drift: best effort
            pass
    # Default thresholds skip sub-second/small executables — exactly the
    # shape-specialized search programs we want cached.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
