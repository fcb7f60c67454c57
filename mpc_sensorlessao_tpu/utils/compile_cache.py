"""Persistent XLA compilation cache location, one rule for every script.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
and nothing is set here.  Otherwise the cache lives at a fixed path inside
the checkout, ``<repo>/.jax_cache`` (git-ignored): the path is part of the
cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
