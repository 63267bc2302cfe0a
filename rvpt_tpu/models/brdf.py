"""BRDF evaluation/sampling and the shared bounce-shading step.

Vectorized re-design of the reference's material library
(assets/shaders/material.glsl) and of the per-bounce material switch shared by
the Whitted/Cook/Kajiya integrators (assets/shaders/integrators.glsl:584-668):
instead of a divergent ``switch``, all three material branches are evaluated
and combined with ``where`` masks — uniform control flow over the ray batch.

Differentiability: albedo/emission/ior gradients flow through the throughput
products; the stochastic Fresnel branch and the discrete material select are
detached (detach-on-branch reparameterization — interior-parameter gradients
match finite differences, edge/visibility gradients are out of scope).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.math import INV_PI, PI, vdot
from ..core.sampling import map_cosine_hemisphere_simple
from ..scene.materials import DIELECTRIC, LAMBERT, MIRROR

EPSILON = 5e-3  # surface offset, reference: compute_pass.comp:9


def fresnel_reflectance(cos_in, cos_out, eta):
    """Unpolarized Fresnel reflectance (reference: material.glsl:207-228)."""
    r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
    r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
    return 0.5 * (r_perp * r_perp + r_par * r_par)


def eval_lambert_cos(diffuse):
    """brdf*cos / pdf for cosine-weighted sampling (material.glsl:78-92)."""
    return diffuse * PI


def scatter_lambert_cos(u, v, normal):
    """Cosine-weighted scatter, unnormalized direction (material.glsl:96-108)."""
    return map_cosine_hemisphere_simple(u, v, normal)


def flip_normal_eta(dir_in, normal, ior):
    """Orient the shading normal against the incident ray and compute the
    relative index of refraction, exactly as the bounce preamble of the
    reference integrators (integrators.glsl:591-612).

    dir_in must be normalized.  Returns (normal, cos_in, eta) where cos_in >= 0
    is |cos| of the incidence angle and eta is outside/inside ratio.
    """
    cos_view = vdot(dir_in, normal)
    flipped = cos_view > 0.0
    cos_in = jnp.abs(cos_view)
    normal = jnp.where(flipped[..., None], -normal, normal)
    eta = jnp.where(flipped, ior, 1.0 / jnp.maximum(ior, 1e-8))
    return normal, cos_in, eta


def shade_and_scatter(pos, normal, dir_in, mat, rnd_u, rnd_v, rnd_fresnel):
    """One bounce of the shared material switch (integrators.glsl:614-668).

    Args:
      pos: f32[N,3] hit positions.
      normal: f32[N,3] *normalized* geometric normals (pre-flip).
      dir_in: f32[N,3] normalized incident directions.
      mat: gathered ``Materials`` rows for each lane.
      rnd_u, rnd_v, rnd_fresnel: f32[N] uniforms.

    Returns (pos_out, dir_out, throughput_factor) for every lane; the caller
    masks by hit-validity.
    """
    normal, cos_in, eta = flip_normal_eta(dir_in, normal, mat.ior)

    # --- Lambert (type 0): cosine-weighted scatter, factor = albedo.
    lam_pos = pos + EPSILON * normal
    lam_dir = scatter_lambert_cos(rnd_u, rnd_v, normal)
    lam_fac = eval_lambert_cos(mat.albedo * INV_PI)

    # --- Mirror (type 1): deterministic reflection, factor = albedo (tint).
    refl_dir = dir_in + (2.0 * cos_in)[..., None] * normal
    mir_pos = pos + EPSILON * normal
    mir_fac = mat.albedo

    # --- Dielectric (type 2): stochastic Fresnel reflect/refract.
    cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    # epsilon floor: d/dx sqrt(0) = inf turns 0*inf = NaN in the backward of
    # masked lanes (TIR), even when the tangent is zero
    cos_out = jnp.sqrt(jnp.maximum(1e-12, cos_out_sqr))
    f_refl = fresnel_reflectance(cos_in, cos_out, eta)
    # Total internal reflection OR a stochastic Fresnel coin flip.  The branch
    # decision is detached; the chosen direction remains differentiable.
    reflect_mask = jax.lax.stop_gradient(
        (cos_out_sqr <= 0.0) | (rnd_fresnel < f_refl)
    )
    refr_dir = eta[..., None] * dir_in + (eta * cos_in - cos_out)[..., None] * normal
    die_pos = jnp.where(
        reflect_mask[..., None], pos + EPSILON * normal, pos - EPSILON * normal
    )
    die_dir = jnp.where(reflect_mask[..., None], refl_dir, refr_dir)
    die_fac = mat.albedo

    is_lam = (mat.kind == LAMBERT)[..., None]
    is_mir = (mat.kind == MIRROR)[..., None]
    is_die = (mat.kind == DIELECTRIC)[..., None]

    pos_out = jnp.where(is_lam, lam_pos, jnp.where(is_mir, mir_pos, die_pos))
    dir_out = jnp.where(is_lam, lam_dir, jnp.where(is_mir, refl_dir, die_dir))
    fac = jnp.where(
        is_lam, lam_fac, jnp.where(is_mir, mir_fac, jnp.where(is_die, die_fac, 0.0))
    )
    return pos_out, dir_out, fac
