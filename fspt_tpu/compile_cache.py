"""Where JAX keeps compiled programs between processes.

JAX's persistent cache is keyed by its directory, so the directory must
not move between runs.  When JAX_COMPILATION_CACHE_DIR is set, JAX reads
it itself and nothing here changes it; otherwise the cache lives at a
fixed path inside the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
