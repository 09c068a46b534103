"""JAX persistent compilation cache placement.

Call `enable_persistent_cache()` before building solvers to persist XLA
executables across processes.  The directory is the one
`JAX_COMPILATION_CACHE_DIR` names when it is set (and no other);
otherwise it is `.jax_cache` at the root of the checkout this package
lives in, a fixed path that `.gitignore` lists.

For the host-side staging artifacts, see solver/serialize.py
(save/load_device_hierarchy) and solver/hierarchy.save_hierarchy —
together they make every deterministic build product reusable."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`<checkout>/.jax_cache`, derived from this package's own path."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_persistent_cache(min_compile_secs: float = 0.5) -> str:
    """Enable jax's persistent compilation cache; returns the dir used."""
    import jax

    cache_dir = os.environ.get(ENV_VAR) or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
