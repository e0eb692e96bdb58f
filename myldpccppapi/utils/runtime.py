"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py,
benchmarks/run_baseline.py): where JAX keeps its persistent compile cache."""
from __future__ import annotations

import os

__all__ = ["REPO_CACHE_DIR", "setup_compile_cache"]

#: the fixed cache directory inside the checkout (listed in .gitignore)
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    ``$JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is (JAX
    reads it itself) and no other directory is set; otherwise the cache
    goes to ``.jax_cache/`` in the checkout.  Returns the directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
