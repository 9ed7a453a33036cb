"""Where compiled programs are kept between processes.

JAX's persistent compile cache lives in ``JAX_COMPILATION_CACHE_DIR`` when
that is set, and otherwise in ``<checkout>/.jax_cache`` (listed in
.gitignore).  The path is fixed, never a temporary name: it is part of
what makes a later process find the entries again.
"""

from __future__ import annotations

import os

# The directory that holds this package (the repository checkout).
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``;
    returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
