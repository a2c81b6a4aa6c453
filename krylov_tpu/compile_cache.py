"""Persistent XLA compilation cache for the command-line entry points.

Every solver compiles to its own XLA program, and a cold process recompiles
all of them.  :func:`enable_compile_cache` points JAX's persistent cache at
one fixed directory so that later processes load those programs instead.
Importing the library sets no global configuration; the scripts and the CLI
call this helper once, before their first compile.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache: fixed, because the directory is part of what the
# cache is looked up by — a path that moved between runs would never hit.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is changed), else ``<checkout>/.jax_cache``.

    Returns the directory in use."""
    import jax

    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
