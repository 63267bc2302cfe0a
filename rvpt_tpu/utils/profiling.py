"""Profiling: device traces + derived throughput metrics.

The reference's only profiling surface is a host frame timer with a 50-frame
rolling window shown in ImGui (src/rvpt/timer.cpp:35-40, rvpt.cpp:264-269)
plus debug-utils object names for external profilers (vk_util.h:31-64).  The
equivalents here are ``jax.profiler`` device traces (viewable in
TensorBoard/XProf — the RenderDoc analog) and named trace annotations around
host-side phases.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace into ``log_dir``.

    Usage::

        with device_trace("/tmp/trace"):
            img = render_sample(...)
            jax.block_until_ready(img)

    View with TensorBoard's profile plugin or xprof.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_card() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (one line per card), or
    None where nvidia-smi is absent or fails.  Runs in a child process that
    never touches JAX; a card below its top power limit runs slower under
    load, so every number taken on the card is reported beside this."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def annotate(name: str):
    """Named region inside a device trace (host-side annotation)."""
    return jax.profiler.TraceAnnotation(name)


def mrays_per_second(width: int, height: int, bounces: int, spp: int,
                     seconds: float) -> float:
    """Throughput of one frame: film rays x bounce upper bound / time.

    This is the BASELINE.md metric convention: every bounce slot counts as a
    ray (the reference's dispatch does the same work per pixel regardless of
    early termination), so numbers are comparable across scenes.
    """
    if seconds <= 0.0:
        return float("inf")
    return width * height * spp * bounces / seconds / 1e6


@dataclass
class StepProfile:
    """Per-step host timing ring, the Timer's profiling-oriented sibling.

    Records (name -> seconds) phase durations per step; ``summary()`` gives
    mean/min/max per phase over the retained window.
    """

    window: int = 50
    _steps: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if not self._steps or name in self._steps[-1]:
            self._steps.append({})
            if len(self._steps) > self.window:
                self._steps.pop(0)
        self._steps[-1][name] = dt

    def summary(self) -> dict:
        out: dict = {}
        for step in self._steps:
            for name, dt in step.items():
                out.setdefault(name, []).append(dt)
        return {
            name: {
                "mean_s": sum(v) / len(v),
                "min_s": min(v),
                "max_s": max(v),
                "count": len(v),
            }
            for name, v in out.items()
        }
