"""Where JAX keeps its persistent compilation cache.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, nothing is
set here.  Otherwise the cache goes to <repo>/.jax_cache (listed in
.gitignore), a fixed path, so repeated runs from one checkout hit it.
"""
from __future__ import annotations

import os

REPO_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in force."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
