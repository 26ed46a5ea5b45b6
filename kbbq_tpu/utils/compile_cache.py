"""JAX's persistent compilation cache, at one fixed place per checkout.

Every entry point (the CLI, bench.py, bench_scaling.py, chip_smoke.py)
calls `enable_compile_cache()` before its first compile, so later
processes on the same checkout reuse each other's executables.

- `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself; nothing is set
  in code.
- otherwise: `<checkout>/.jax_cache`, derived from this package's own
  path.  The path is part of what a cache hit needs, so it never
  depends on the working directory, a temp name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """`<checkout>/.jax_cache`: next to the `kbbq_tpu` package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
