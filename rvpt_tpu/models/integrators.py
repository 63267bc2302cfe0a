"""The eleven integrators, vectorized over ray batches.

Re-design of assets/shaders/integrators.glsl:24-693: every integrator is a
pure function over ``[N]`` ray batches.  Per-ray early ``return``s become
termination masks; the per-bounce loops become ``lax.scan`` with carried
(origin, direction, color, throughput, active) state so reverse-mode autodiff
gets a clean chain.  Termination semantics exactly match the reference:
a path contributes only when it terminates inside the bounce budget (the
reference returns black when the loop runs out — integrators.glsl:675);
``style='standard'`` instead keeps the accumulated emission (useful for
inverse rendering in closed scenes).

Integrator ids (= reference render-mode indices, compute_pass.comp:68-99):
  0 binary, 1 color, 2 depth, 3 normal, 4 Utah, 5 AO, 6 Appel, 7 Whitted,
  8 Cook, 9 Kajiya, 10 Hart.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.math import mix, normalize, vdot
from ..core.types import Ray
from ..ops import sdf as sdf_ops
from ..ops.intersect import (closest_hit_scene, intersect_scene,
                             isect_from_hit, occluded)
from ..scene.materials import LAMBERT, gather
from . import brdf

WHITE = jnp.array([1.0, 1.0, 1.0], jnp.float32)
BLUE = jnp.array([0.2, 0.3, 0.7], jnp.float32)
LIGHT_DIR = jnp.array([0.5, 1.0, 0.3], jnp.float32) / jnp.linalg.norm(
    jnp.array([0.5, 1.0, 0.3])
)
LIGHT_INTENSITY = 1.0
AMBIENT = 0.1
INF = jnp.float32(jnp.inf)

# RNG salt layout: salt = aa_index * AA_STRIDE + bounce * BOUNCE_STRIDE + site.
BOUNCE_STRIDE = 4
AA_STRIDE = 4096


def _sky(direction, half_shift: bool):
    """Background gradient.  Kajiya shifts d.y into [0,1]
    (integrators.glsl:579); Utah/Whitted/Cook use raw d.y (glsl mix
    extrapolates outside [0,1] — preserved)."""
    y = direction[..., 1]
    t = y * 0.5 + 0.5 if half_shift else y
    return mix(WHITE[None, :], BLUE[None, :], t[..., None])


# ---------------------------------------------------------------------------
# Single-intersection debug integrators
# ---------------------------------------------------------------------------


def integrator_binary(scene, ray, pixel, frame, settings, salt_base=0):
    """(1,1,1) on any primary hit (integrators.glsl:24-38)."""
    hit = occluded(scene, ray, 0.0, INF)
    return jnp.broadcast_to(hit[:, None].astype(jnp.float32), (*hit.shape, 3))


def integrator_color(scene, ray, pixel, frame, settings, salt_base=0):
    """Base color of the first hit (integrators.glsl:42-59)."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    mat = gather(scene.materials, isect.mat)
    return jnp.where(isect.hit[:, None], mat.albedo, 0.0)


def integrator_depth(scene, ray, pixel, frame, settings, salt_base=0):
    """Reciprocal distance along the ray (integrators.glsl:63-82);
    misses give 1/inf = 0."""
    from ..core.math import length

    isect = intersect_scene(scene, ray, 0.0, INF)
    inv_dist = 1.0 / (length(ray.direction) * isect.t)
    return jnp.broadcast_to(inv_dist[:, None], (*inv_dist.shape, 3))


def integrator_normal(scene, ray, pixel, frame, settings, salt_base=0):
    """0.5*normal + 0.5 on hit, black on miss (integrators.glsl:86-102)."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    return 0.5 * isect.normal + 0.5 * isect.hit[:, None].astype(jnp.float32)


def integrator_utah(scene, ray, pixel, frame, settings, salt_base=0):
    """Rasterizer-like directional-light shading, no shadows
    (integrators.glsl:106-148)."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    mat = gather(scene.materials, isect.mat)
    sky = _sky(ray.direction, half_shift=False)

    normal = isect.normal
    facing = vdot(ray.direction, normal) < 0.0
    normal = jnp.where(facing[:, None], normal, -normal)
    cos_light = jnp.maximum(0.0, vdot(LIGHT_DIR[None, :], normal))
    col = AMBIENT + mat.emission + mat.albedo * LIGHT_INTENSITY * cos_light[:, None]
    return jnp.where(isect.hit[:, None], col, sky)


def integrator_appel(scene, ray, pixel, frame, settings, salt_base=0):
    """Directional light + hard shadow (integrators.glsl:204-250);
    misses return white."""
    isect = intersect_scene(scene, ray, 0.0, INF)
    dir_in = normalize(ray.direction)
    cos_view = vdot(dir_in, isect.normal)
    normal = jnp.where((cos_view > 0.0)[:, None], -isect.normal, isect.normal)
    shadow_origin = isect.pos + brdf.EPSILON * normal
    shadow_dir = jnp.broadcast_to(LIGHT_DIR[None, :], normal.shape)
    in_shadow = occluded(scene, Ray(shadow_origin, shadow_dir), 0.0, INF)
    cos_light = jnp.maximum(0.0, vdot(LIGHT_DIR[None, :], normal))
    lit = LIGHT_INTENSITY * cos_light[:, None] * jnp.ones_like(normal)
    col = jnp.where(in_shadow[:, None], 0.0, lit)
    return jnp.where(isect.hit[:, None], col, 1.0)


def integrator_ao(scene, ray, pixel, frame, settings, salt_base=0):
    """Cosine-weighted ambient occlusion with ``max_bounces`` probe rays
    (integrators.glsl:152-200; ray count wired from the settings exactly as
    compute_pass.comp:87)."""
    nrays = max(int(settings.max_bounces), 1)
    isect = intersect_scene(scene, ray, 0.0, INF)
    dir_in = ray.direction
    facing = vdot(dir_in, isect.normal) < 0.0
    normal = jnp.where(facing[:, None], isect.normal, -isect.normal)
    origin = isect.pos + brdf.EPSILON * normal

    def body(i, acc):
        u, v = rng.uniform2(pixel, frame, salt_base + i * BOUNCE_STRIDE)
        d = brdf.scatter_lambert_cos(u, v, normal)
        return acc + occluded(scene, Ray(origin, d), 0.0, INF).astype(jnp.float32)

    acc = jax.lax.fori_loop(0, nrays, body, jnp.zeros(isect.t.shape, jnp.float32))
    ao = 1.0 - acc / nrays
    return jnp.where(isect.hit[:, None], ao[:, None] * jnp.ones((1, 3)), 0.0)


# ---------------------------------------------------------------------------
# Bounce-loop integrators (Whitted / Cook / Kajiya)
# ---------------------------------------------------------------------------


def _remat(step):
    """Rematerialize each bounce in the backward pass.

    Reverse-mode through the bounce scan would otherwise store every
    intermediate of every bounce (the [rays, prims] search tiles included) —
    at 1080p that exceeds HBM.  Checkpointing stores only the per-bounce
    carry (~a dozen [N] arrays) and recomputes the rest: the classic
    FLOPs-for-memory trade, and the bounce recompute is exactly one extra
    forward intersect per bounce.
    """
    return jax.checkpoint(step, prevent_cse=False)


def _flat_scan(step, init, xs):
    """Rematerialized lax.scan whose [N,3] carry components are stored as
    flat [N] arrays (the residual stack the backward keeps per bounce); the
    stack/unstack fuses into the bounce body.
    """
    is3 = [a.ndim == 2 and a.shape[-1] == 3 for a in init]

    def pack(carry):
        flat = []
        for a, v3 in zip(carry, is3):
            flat += [a[:, 0], a[:, 1], a[:, 2]] if v3 else [a]
        return tuple(flat)

    def unpack(flat):
        out, i = [], 0
        for v3 in is3:
            if v3:
                out.append(jnp.stack(flat[i : i + 3], axis=-1))
                i += 3
            else:
                out.append(flat[i])
                i += 1
        return tuple(out)

    def body(flat, x):
        new_carry, y = step(unpack(flat), x)
        return pack(new_carry), y

    flat_final, ys = jax.lax.scan(_remat(body), pack(init), xs)
    return unpack(flat_final), ys


def _bounce_rands(pixel, frame, salt_base, bounce):
    salt = salt_base + bounce * BOUNCE_STRIDE
    return rng.uniform3(pixel, frame, salt)


def kajiya_with_hits(scene, ray, pixel, frame, max_bounces: int,
                     style: str = "reference", salt_base=0):
    """Standard path tracing (integrators.glsl:547-677) that also returns
    each bounce's detached hit record.

    Returns (radiance f32[N,3], fams i32[B,N], idxs i32[B,N]): the primitive
    family and index ``closest_hit_scene`` chose at every bounce — the
    forward half of the hit-record gradient (ops.fast_grad).
    """
    nbounce = int(max_bounces)
    n = ray.origin.shape[0]

    def step(carry, bounce):
        o, d, col, thr, active, result = carry
        fam, idx, _ = closest_hit_scene(scene, Ray(o, d), 0.0, INF)
        isect = isect_from_hit(scene, Ray(o, d), fam, idx, 0.0)
        hit = isect.hit
        miss_now = active & ~hit
        sky = _sky(d, half_shift=True)
        result = result + jnp.where(miss_now[:, None], col + thr * sky, 0.0)
        active = active & hit

        mat = gather(scene.materials, isect.mat)
        col = col + jnp.where(active[:, None], thr * mat.emission, 0.0)

        dir_in = normalize(d)
        u, v, w = _bounce_rands(pixel, frame, salt_base, bounce)
        pos_out, dir_out, fac = brdf.shade_and_scatter(
            isect.pos, isect.normal, dir_in, mat, u, v, w
        )
        thr = jnp.where(active[:, None], thr * fac, thr)
        o = jnp.where(active[:, None], pos_out, o)
        d = jnp.where(active[:, None], dir_out, d)
        return (o, d, col, thr, active, result), (fam, idx)

    init = (
        ray.origin,
        ray.direction,
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        jnp.zeros((n, 3), jnp.float32),
    )
    (o, d, col, thr, active, result), (fams, idxs) = _flat_scan(
        step, init, jnp.arange(nbounce, dtype=jnp.uint32)
    )
    if style == "standard":
        result = result + jnp.where(active[:, None], col, 0.0)
    return result, fams, idxs


def integrator_kajiya(scene, ray, pixel, frame, settings, salt_base=0):
    """Standard path tracing (integrators.glsl:547-677)."""
    return kajiya_with_hits(scene, ray, pixel, frame, settings.max_bounces,
                            settings.style, salt_base)[0]


def integrator_whitted(scene, ray, pixel, frame, settings, salt_base=0):
    """Whitted-style: direct Lambert lighting, stochastic reflect/refract
    choice for dielectrics (integrators.glsl:254-403).  Starts from an
    ambient term; Lambert hits terminate the path."""
    nbounce = int(settings.max_bounces)
    n = ray.origin.shape[0]

    def step(carry, bounce):
        o, d, col, thr, active, result = carry
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        hit = isect.hit
        miss_now = active & ~hit
        sky = _sky(d, half_shift=False)
        result = result + jnp.where(miss_now[:, None], col + thr * sky, 0.0)
        active = active & hit

        mat = gather(scene.materials, isect.mat)
        col = col + jnp.where(active[:, None], thr * mat.emission, 0.0)

        dir_in = normalize(d)
        normal_f, _, _ = brdf.flip_normal_eta(dir_in, isect.normal, mat.ior)

        # Lambert lanes: direct light + hard shadow, then terminate.
        is_lam = active & (mat.kind == LAMBERT)
        shadow_origin = isect.pos + brdf.EPSILON * normal_f
        shadow_dir = jnp.broadcast_to(LIGHT_DIR[None, :], normal_f.shape)
        in_shadow = occluded(scene, Ray(shadow_origin, shadow_dir), 0.0, INF)
        cos_light = jnp.maximum(0.0, vdot(LIGHT_DIR[None, :], normal_f))
        direct = col + thr * mat.albedo * LIGHT_INTENSITY * cos_light[:, None]
        lam_out = jnp.where(in_shadow[:, None], col, direct)
        result = result + jnp.where(is_lam[:, None], lam_out, 0.0)
        active = active & ~is_lam

        u, v, w = _bounce_rands(pixel, frame, salt_base, bounce)
        pos_out, dir_out, fac = brdf.shade_and_scatter(
            isect.pos, isect.normal, dir_in, mat, u, v, w
        )
        thr = jnp.where(active[:, None], thr * fac, thr)
        o = jnp.where(active[:, None], pos_out, o)
        d = jnp.where(active[:, None], dir_out, d)
        return (o, d, col, thr, active, result), None

    init = (
        ray.origin,
        ray.direction,
        jnp.full((n, 3), jnp.float32(AMBIENT)),
        jnp.ones((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        jnp.zeros((n, 3), jnp.float32),
    )
    (_, _, col, _, active, result), _ = _flat_scan(
        step, init, jnp.arange(nbounce, dtype=jnp.uint32)
    )
    if settings.style == "standard":
        result = result + jnp.where(active[:, None], col, 0.0)
    return result


def integrator_cook(scene, ray, pixel, frame, settings, salt_base=0):
    """Cook distributed ray tracing: Lambert scatters exactly once more, then
    the path terminates on that second hit's emission or the sky
    (integrators.glsl:407-543).  Implemented with a carried ``final`` mask so
    each bounce still costs a single scene intersection."""
    nbounce = int(settings.max_bounces)
    n = ray.origin.shape[0]

    def step(carry, bounce):
        o, d, col, thr, active, final, result = carry
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        hit = isect.hit
        miss_now = active & ~hit
        sky = _sky(d, half_shift=False)
        result = result + jnp.where(miss_now[:, None], col + thr * sky, 0.0)
        active = active & hit

        mat = gather(scene.materials, isect.mat)

        # Lanes whose previous bounce was a Lambert scatter: terminate on this
        # hit's emission (the reference's inlined second intersection,
        # integrators.glsl:483-487).
        fin_now = active & final
        result = result + jnp.where(fin_now[:, None], col + thr * mat.emission, 0.0)
        active = active & ~final

        col = col + jnp.where(active[:, None], thr * mat.emission, 0.0)

        dir_in = normalize(d)
        u, v, w = _bounce_rands(pixel, frame, salt_base, bounce)
        pos_out, dir_out, fac = brdf.shade_and_scatter(
            isect.pos, isect.normal, dir_in, mat, u, v, w
        )
        is_lam = active & (mat.kind == LAMBERT)
        final = is_lam
        thr = jnp.where(active[:, None], thr * fac, thr)
        o = jnp.where(active[:, None], pos_out, o)
        d = jnp.where(active[:, None], dir_out, d)
        return (o, d, col, thr, active, final, result), None

    init = (
        ray.origin,
        ray.direction,
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        jnp.zeros((n,), bool),
        jnp.zeros((n, 3), jnp.float32),
    )
    (o, d, col, thr, active, final, result), _ = _flat_scan(
        step, init, jnp.arange(nbounce, dtype=jnp.uint32)
    )
    # The reference performs the Lambert follow-up intersection inside the same
    # loop iteration, so a Lambert scatter on the last bounce still resolves.
    fin = active & final
    if nbounce > 0:
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        mat = gather(scene.materials, isect.mat)
        sky = _sky(d, half_shift=False)
        tail = jnp.where(isect.hit[:, None], col + thr * mat.emission, col + thr * sky)
        result = result + jnp.where(fin[:, None], tail, 0.0)
        active = active & ~final
    if settings.style == "standard":
        result = result + jnp.where(active[:, None], col, 0.0)
    return result


def integrator_hart(scene, ray, pixel, frame, settings, salt_base=0):
    """Sphere-tracing iteration heat map (integrators.glsl:681-693)."""
    t, radius, iters = sdf_ops.sphere_trace(scene, ray.origin, ray.direction, 0.0, INF)
    val = iters.astype(jnp.float32) / jnp.float32(sdf_ops.MARCH_ITER - 1)
    return jnp.broadcast_to(val[:, None], (*val.shape, 3))


INTEGRATORS = {
    0: integrator_binary,
    1: integrator_color,
    2: integrator_depth,
    3: integrator_normal,
    4: integrator_utah,
    5: integrator_ao,
    6: integrator_appel,
    7: integrator_whitted,
    8: integrator_cook,
    9: integrator_kajiya,
    10: integrator_hart,
}

INTEGRATOR_NAMES = {
    "binary": 0,
    "color": 1,
    "depth": 2,
    "normal": 3,
    "utah": 4,
    "ao": 5,
    "appel": 6,
    "whitted": 7,
    "cook": 8,
    "kajiya": 9,
    "hart": 10,
}


def eval_integrator(mode: int, scene, ray, pixel, frame, settings, salt_base=0):
    """Static dispatch by integrator id (compute_pass.comp:68-99); ids outside
    the table fall back to Hart, like the reference's ``default`` case."""
    fn = INTEGRATORS.get(int(mode), integrator_hart)
    return fn(scene, ray, pixel, frame, settings, salt_base)
