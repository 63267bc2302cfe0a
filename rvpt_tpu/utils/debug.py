"""Debug/validation toggles.

The reference's equivalents are Vulkan validation layers + ASan in debug
builds (SURVEY.md §5 "race detection / sanitizers"); under XLA the runtime
owns ordering, so what remains useful is numeric validation: NaN/Inf checks
and op-by-op execution.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def validation(nan_checks: bool = True, disable_jit: bool = False):
    """The debug-build mode: raise on NaN/Inf production (jax_debug_nans),
    optionally run op-by-op (disable_jit) for python-level stack traces."""
    old_nan = jax.config.jax_debug_nans
    old_jit = jax.config.jax_disable_jit
    try:
        jax.config.update("jax_debug_nans", nan_checks)
        if disable_jit:
            jax.config.update("jax_disable_jit", True)
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nan)
        jax.config.update("jax_disable_jit", old_jit)
