"""Test harness: an 8-device virtual CPU mesh unless a GPU run is asked for.

The reference has no test suite at all (SURVEY.md §4); this is the fake-
backend capability it lacks — multi-device sharding tests run on virtual CPU
devices, so the suite needs no accelerator.

``JAX_PLATFORMS`` set to a GPU platform (``cuda`` or ``gpu``) keeps the
card: that is how the tests marked ``gpu`` run on a machine with one
(``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``).  Any other value
is overridden with the CPU.  Whether a card is present is decided inside
the ``gpu_device`` fixture, never while a module is imported.
"""

import os

import pytest

GPU_PLATFORMS = ("cuda", "gpu")
_WANT_GPU = os.environ.get("JAX_PLATFORMS", "").lower() in GPU_PLATFORMS

if not _WANT_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # The persistent compilation cache stays off on the CPU (see
    # rvpt_tpu/utils/compile_cache.py for why).
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    # In case a plugin imported jax before this file ran: the config update
    # still takes while no backend exists.
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {dev.platform}")
    return dev
