"""Persistent XLA compilation cache for rso's entry points.

The KITTI-size step takes tens of seconds to compile; the cache lets the
next process on the same machine skip that.  Entry points (bench.py,
chip_smoke.py and the rso.cli mains that compile) call `enable()`;
importing rso does not, so library users and tests keep JAX's own
settings.

If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
changed.  Otherwise the cache goes to a fixed `.jax_cache` directory beside
the rso package (the checkout root, git-ignored).  The path is fixed (no
temp name, pid or time in it), so the next process finds what this one
wrote.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
