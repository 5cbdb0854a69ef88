"""Persistent XLA compilation cache: one policy for every entry point.

Compiling the tree programs takes seconds to minutes on a GPU, and a
fresh process pays it again unless the compiled executables persist.
:func:`enable_compile_cache` is called by the CLI, ``bench.py`` and
``chip_smoke.py`` before their first compilation.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

#: Fixed cache directory inside the checkout (listed in .gitignore).  The
#: path is part of what a later process must find, so it never comes from
#: a temporary name, a process id or the time.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
