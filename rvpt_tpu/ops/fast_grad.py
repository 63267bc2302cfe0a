"""Hit-record gradient for the Kajiya path tracer.

Autodiff through the XLA integrator re-runs every closest-hit search in its
rematerialized backward.  This module pairs:

  forward   = the XLA Kajiya bounce chain (models.integrators
              .kajiya_with_hits), which records the detached (family,
              index) that ``closest_hit_scene`` picked at every bounce;
  backward  = reverse-mode AD of a *replay from hits* (ops.replay_soa): the
              same bounce chain with every closest-hit search replaced by the
              O(N) differentiable rebuild of the recorded winner — no
              [rays x prims] work at all.

The discrete search runs once, in the forward; the differentiable chain is
replayed exactly, reusing identical RNG streams.  Nothing here depends on
the platform: the forward's search follows ``ops.route``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import normalize
from ..core.types import Ray
from ..models import brdf
from ..models.integrators import (_bounce_rands, _flat_scan, _sky,
                                  kajiya_with_hits)
from ..scene.materials import gather
from .intersect import isect_from_hit


def kajiya_from_hits(scene, ray, pixel, frame, salt_base, fams, idxs,
                     style="reference"):
    """Differentiable replay of a Kajiya trace given per-bounce hit records.

    fams/idxs: i32[B, N] hit records (models.integrators.kajiya_with_hits).
    Returns radiance f32[N, 3]: the [N,3]-layout twin of
    ops.replay_soa.kajiya_replay_soa, fully differentiable w.r.t. scene and
    rays.
    """
    n = ray.origin.shape[0]
    nbounce = fams.shape[0]

    def step(carry, x):
        o, d, col, thr, active, result = carry
        fam, idx, bounce = x
        isect = isect_from_hit(scene, Ray(o, d), fam, idx, mint=0.0)
        hit = fam >= 0
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
        return (o, d, col, thr, active, result), None

    init = (
        ray.origin,
        ray.direction,
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        jnp.zeros((n, 3), jnp.float32),
    )
    (o, d, col, thr, active, result), _ = _flat_scan(
        step, init, (fams, idxs, jnp.arange(nbounce, dtype=jnp.uint32))
    )
    if style == "standard":
        result = result + jnp.where(active[:, None], col, 0.0)
    return result


def make_fast_kajiya(scene_template, salt_base: int, max_bounces: int,
                     style: str = "reference"):
    """Build the custom-VJP Kajiya trace for scenes shaped like
    ``scene_template``.  Returns trace(scene, origin, direction, pixel,
    frame, salt=0) -> radiance f32[N,3]; ``salt`` is an extra traced u32
    RNG-stream offset (e.g. per spp rank) added to the static ``salt_base``.
    """
    del scene_template  # shapes come from the traced scene

    def _forward(scene, origin, direction, pixel, frame, salt):
        return kajiya_with_hits(
            scene, Ray(origin, direction), pixel, frame, max_bounces, style,
            jnp.asarray(salt, jnp.uint32) + jnp.uint32(salt_base))

    @jax.custom_vjp
    def trace6(scene, origin, direction, pixel, frame, salt):
        return _forward(scene, origin, direction, pixel, frame, salt)[0]

    def fwd(scene, origin, direction, pixel, frame, salt):
        out, fams, idxs = _forward(scene, origin, direction, pixel, frame,
                                   salt)
        return out, (scene, origin, direction, pixel, frame, salt, fams, idxs)

    def bwd(res, g):
        scene, origin, direction, pixel, frame, salt, fams, idxs = res
        from .replay_soa import kajiya_replay_soa

        def replay(scene, o, d):
            return kajiya_replay_soa(
                scene, o, d, pixel, frame,
                jnp.asarray(salt, jnp.uint32) + jnp.uint32(salt_base),
                fams, idxs, style,
            )

        _, vjp_fn = jax.vjp(replay, scene, origin, direction)
        g_scene, g_o, g_d = vjp_fn(g)
        f0 = jax.dtypes.float0
        return (
            g_scene,
            g_o,
            g_d,
            np.zeros(pixel.shape, f0),
            np.zeros(frame.shape, f0),
            np.zeros(jnp.shape(salt), f0),
        )

    trace6.defvjp(fwd, bwd)

    def trace(scene, origin, direction, pixel, frame, salt=0):
        return trace6(scene, origin, direction, pixel, frame,
                      jnp.asarray(salt, jnp.uint32))

    return trace
