"""Stateless, counter-based device RNG.

The reference keeps a per-pixel xorshift32 state seeded with
``wang_hash(pixel_index) + frame`` (reference: assets/shaders/util.glsl:25-50).
Mutable per-lane state is the wrong shape for XLA, so the design here is
a *counter-based* hash RNG: every draw is a pure function of
``(pixel, frame, lane, salt)``.  That gives

* determinism across backends/shardings (each pixel's stream depends only on
  its logical coordinates, never on device layout), and
* zero memory traffic (no 20k-float upload per frame — the reference uploads a
  random buffer every frame that its shader never reads,
  src/rvpt/rvpt.cpp:113 vs assets/shaders/util.glsl).

The hash is PCG3D/PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) — 3/4 u32 in, 3/4 well-distributed u32 out, built from modular u32
arithmetic which XLA lowers to plain vector ops.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32
_LCG_MUL = jnp.uint32(1664525)
_LCG_ADD = jnp.uint32(1013904223)
# 1/2^24 — convert the top 24 bits of a u32 into a float32 in [0, 1).
_INV_2_24 = jnp.float32(1.0 / 16777216.0)


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x).astype(_U32)


def pcg3d(v0, v1, v2):
    """PCG3D hash: three u32 streams in, three decorrelated u32 streams out."""
    x, y, z = _u32(v0), _u32(v1), _u32(v2)
    x = x * _LCG_MUL + _LCG_ADD
    y = y * _LCG_MUL + _LCG_ADD
    z = z * _LCG_MUL + _LCG_ADD
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def pcg4d(v0, v1, v2, v3):
    """PCG4D hash: four u32 streams in, four decorrelated u32 streams out."""
    x, y, z, w = _u32(v0), _u32(v1), _u32(v2), _u32(v3)
    x = x * _LCG_MUL + _LCG_ADD
    y = y * _LCG_MUL + _LCG_ADD
    z = z * _LCG_MUL + _LCG_ADD
    w = w * _LCG_MUL + _LCG_ADD
    x = x + y * w
    y = y + z * x
    z = z + x * w
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * w
    w = w + y * z
    return x, y, z, w


def u32_to_unit_float(bits: jnp.ndarray) -> jnp.ndarray:
    """Top 24 bits of a u32 -> float32 uniform in [0, 1)."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * _INV_2_24


def uniform3(pixel, frame, salt):
    """Three independent uniforms in [0,1) per lane.

    ``pixel`` is any-shaped u32 lane index (e.g. flattened pixel id), ``frame``
    and ``salt`` are scalars or broadcastable counters (frame number, bounce
    index, draw index).  Pure function — same args, same randoms, on any
    backend and under any sharding.
    """
    a, b, c = pcg3d(pixel, frame, salt)
    return u32_to_unit_float(a), u32_to_unit_float(b), u32_to_unit_float(c)


def uniform4(pixel, frame, salt, salt2):
    a, b, c, d = pcg4d(pixel, frame, salt, salt2)
    return (
        u32_to_unit_float(a),
        u32_to_unit_float(b),
        u32_to_unit_float(c),
        u32_to_unit_float(d),
    )


def uniform2(pixel, frame, salt):
    a, b, _ = uniform3(pixel, frame, salt)
    return a, b


def uniform1(pixel, frame, salt):
    (a, _, _) = uniform3(pixel, frame, salt)
    return a
