"""JAX's persistent compilation cache for the entry points.

One rule for every script that compiles the big programs (``chip_smoke.py``,
the ``bench*.py`` harnesses, ``examples/train_*.py``,
``experiments/train_compare.py``): when ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing else is set; otherwise the cache lives
in ``.jax_cache`` at the root of the checkout this file belongs to (listed
in ``.gitignore``). The path is part of the cache's key, so it is derived
from the file's location and never from a temporary directory, a process
id or the time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The directory the rule above selects."""
    return os.environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Apply the rule; returns the cache directory in use."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    return cache_dir()
