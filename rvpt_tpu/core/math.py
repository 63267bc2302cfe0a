"""Core vector math, structure-of-arrays style.

Vectors are ``f32[..., 3]`` arrays; every function is shape-polymorphic over
leading batch dimensions so the whole film's worth of rays is processed as one
vectorized program (the replacement for the reference's per-pixel
GLSL helpers, reference: assets/shaders/util.glsl:54-156).
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-8
INF = jnp.inf
PI = 3.141592653589793
TWO_PI = 6.283185307179586
INV_PI = 0.3183098861837907


def vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing xyz axis."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product over the trailing xyz axis."""
    return jnp.cross(a, b)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(vdot(v, v))


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize trailing-axis vectors. ``eps`` guards zero vectors."""
    n2 = vdot(v, v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, EPS * EPS)), 0.0)
    return v * inv[..., None]


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of incident direction ``d`` about unit normal ``n``.

    Same convention as the reference's educational variant
    (assets/shaders/material.glsl:26-45): dot(d, n) <= 0 for an incoming ray.
    """
    return d - 2.0 * vdot(d, n)[..., None] * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction; returns the zero vector on total internal reflection.

    Mirrors GLSL ``refract`` semantics used by the reference
    (assets/shaders/material.glsl:49-74): ``eta`` is the outside/inside index
    ratio and ``dot(d, n) <= 0``.
    """
    eta = jnp.asarray(eta)
    cos_a = vdot(d, n)
    cos_b_sqr = 1.0 - eta * eta * (1.0 - cos_a * cos_a)
    tir = cos_b_sqr <= 0.0
    cos_b = jnp.sqrt(jnp.maximum(1e-12, cos_b_sqr))
    out = eta[..., None] * d - (eta * cos_a + cos_b)[..., None] * n
    return jnp.where(tir[..., None], 0.0, out)


def spherical_to_cartesian(r, phi, theta):
    """Physics/CG convention: x=r cos(phi) sin(theta), y=r sin(phi) sin(theta),
    z=r cos(theta) (reference: assets/shaders/util.glsl:54-73)."""
    sin_theta = jnp.sin(theta)
    return jnp.stack(
        [
            r * sin_theta * jnp.cos(phi),
            r * sin_theta * jnp.sin(phi),
            r * jnp.cos(theta),
        ],
        axis=-1,
    )


def unit_spherical_to_cartesian(phi, theta):
    """Unit-sphere specialization (reference: assets/shaders/util.glsl:77-96)."""
    sin_theta = jnp.sin(theta)
    return jnp.stack(
        [
            sin_theta * jnp.cos(phi),
            sin_theta * jnp.sin(phi),
            jnp.cos(theta),
        ],
        axis=-1,
    )


def orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Branchless orthonormal basis {e0, e1, n} around unit vector ``n``.

    Duff et al., "Building an Orthonormal Basis, Revisited" (JCGT 2017) — the
    same construction the reference uses (assets/shaders/util.glsl:100-123),
    expressed with ``where`` instead of a scalar branch so it vectorizes on the
    VPU.
    """
    z = n[..., 2]
    sign = jnp.where(z < 0.0, -1.0, 1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    e0 = jnp.stack(
        [
            1.0 + sign * n[..., 0] * n[..., 0] * a,
            sign * b,
            -sign * n[..., 0],
        ],
        axis=-1,
    )
    e1 = jnp.stack(
        [
            b,
            sign + n[..., 1] * n[..., 1] * a,
            -n[..., 1],
        ],
        axis=-1,
    )
    return e0, e1


def hemisphere_around_normal(phi, cos_theta, sin_theta, n):
    """Map spherical angles onto the hemisphere centered on ``n``
    (reference: assets/shaders/util.glsl:127-155)."""
    x = jnp.cos(phi) * sin_theta
    y = jnp.sin(phi) * sin_theta
    z = cos_theta
    e0, e1 = orthonormal_basis(n)
    return x[..., None] * e0 + y[..., None] * e1 + z[..., None] * n


def mix(a, b, t):
    """GLSL mix: linear blend (extrapolates outside [0,1], as the reference's
    sky gradient relies on — assets/shaders/integrators.glsl:578-579)."""
    return a + (b - a) * t
