"""Persistent XLA compilation cache.

The 1080p mesh programs take seconds to minutes to compile; XLA can keep
compiled executables on disk, keyed by program fingerprint, so a later
process skips the compile.  Where the cache lives (``cache_dir``):

  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it; nothing else is
    set here.
  * otherwise, on a GPU: ``.jax_cache/`` inside this checkout — one fixed
    path, so every run of this checkout finds the entries of the last.
  * otherwise (CPU): off.  Cached CPU executables are specialised to the
    host's CPU features, and on machines whose advertised features vary
    between runs a stale hit has produced wrong results and multi-minute
    hangs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(platform: str, environ=None) -> str | None:
    """The cache directory for ``platform`` under ``environ`` (default:
    ``os.environ``), or None when the cache stays off."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    if platform == "gpu":
        return str(CHECKOUT_DIR)
    return None


def enable() -> str | None:
    """Turn the cache on for the current platform; returns its directory,
    or None when it stays off."""
    import jax

    from ..ops.route import platform

    path = cache_dir(platform())
    if path is not None and not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
