"""Component-SoA differentiable replay of the Kajiya bounce chain.

The backward half of the hit-record gradient (ops.fast_grad): given the
forward's per-bounce hit records, replay the trace differentiably.  Every
intermediate is a flat [N] component array and every table lookup a
per-component gather, so the pullback is elementwise work plus one
scatter-add per looked-up table and bounce.

Semantically identical to ops.fast_grad.kajiya_from_hits (tested).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.math import INV_PI, PI, TWO_PI

_EPSILON = 5e-3
_DENOM_EPS = 1e-30
_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.2, 0.3, 0.7)


def _safe_div(num, den):
    return num / jnp.where(jnp.abs(den) < _DENOM_EPS, _DENOM_EPS, den)


def _rsqrt_safe(x):
    return jax.lax.rsqrt(jnp.maximum(x, 1e-30))


# Tables at or below this row count use the select-sum lookup; larger ones
# use a plain gather, whose transpose XLA emits as a scatter-add.
_LOOKUP_UNROLL = 64


def _lookup(table, idx):
    """table[idx]: an unrolled sum of masked broadcasts for small tables
    (the cotangent becomes a masked reduction instead of a scatter), a
    plain gather above ``_LOOKUP_UNROLL`` rows.  ``idx`` must lie in
    [0, len(table))."""
    t = table.shape[0]
    if t > _LOOKUP_UNROLL:
        return table[idx]
    out = jnp.zeros(idx.shape, table.dtype)
    for k in range(t):
        out = jnp.where(idx == k, table[k], out)
    return out


def _lookup_group(tables, idx):
    """Shared-index lookup across several same-length [T] tables;
    ``idx`` must be pre-clipped to [0, T)."""
    return tuple(_lookup(tab, idx) for tab in tables)


def kajiya_replay_soa(scene, origin, direction, pixel, frame, salt_base,
                      fams, idxs, style="reference", remat=False):
    """Radiance f32[N,3] from recorded hits, all-[N]-component internals.

    ``remat=False`` stores per-bounce carries (16 flat [N] arrays per bounce;
    ~130MB at 1080p x 4 bounces) — cheaper than recomputing each bounce in
    the backward since the search is already gone.
    """
    from ..core import rng as rng_mod

    n = origin.shape[0]
    nbounce = fams.shape[0]
    has_tri = scene.num_triangles > 0
    has_sph = scene.num_spheres > 0
    has_pln = scene.num_planes > 0

    # Pre-split static scene tables into components (tiny, outside the scan).
    if has_tri:
        t_v0 = [scene.tri_v0[:, k] for k in range(3)]
        t_v1 = [scene.tri_v1[:, k] for k in range(3)]
        t_v2 = [scene.tri_v2[:, k] for k in range(3)]
    if has_sph:
        s_c = [scene.sph_center[:, k] for k in range(3)]
        s_r = scene.sph_radius
    if has_pln:
        p_n = [scene.pln_normal[:, k] for k in range(3)]
        p_d = scene.pln_d
    m_alb = [scene.materials.albedo[:, k] for k in range(3)]
    m_em = [scene.materials.emission[:, k] for k in range(3)]
    m_ior = scene.materials.ior
    m_kind = scene.materials.kind
    tri_mat = scene.tri_mat if has_tri else None
    sph_mat = scene.sph_mat if has_sph else None
    pln_mat = scene.pln_mat if has_pln else None
    n_mat = max(scene.materials.count, 1)

    def step(carry, x):
        (ox, oy, oz, dx, dy, dz,
         tr, tg, tb, cr, cg, cb,
         rr, rg, rb, active) = carry
        fam, idx, bounce = x

        # ---------------------------------------------- differentiable t + n
        t = jnp.zeros((n,), jnp.float32)
        wnx = jnp.zeros((n,), jnp.float32)
        wny = jnp.zeros((n,), jnp.float32)
        wnz = jnp.zeros((n,), jnp.float32)
        mat_id = jnp.zeros((n,), jnp.int32)

        if has_tri:
            m = fam == 0
            safe = jnp.clip(idx, 0, scene.num_triangles - 1)
            (v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z) = _lookup_group(
                tuple(t_v0) + tuple(t_v1) + tuple(t_v2), safe)
            e0x, e0y, e0z = v1x - v0x, v1y - v0y, v1z - v0z
            e1x, e1y, e1z = v2x - v0x, v2y - v0y, v2z - v0z
            nx = e0y * e1z - e0z * e1y
            ny = e0z * e1x - e0x * e1z
            nz = e0x * e1y - e0y * e1x
            dn = dx * nx + dy * ny + dz * nz
            t_t = _safe_div(
                (v0x - ox) * nx + (v0y - oy) * ny + (v0z - oz) * nz, dn
            )
            t = jnp.where(m, jnp.clip(t_t, -1e6, 1e6), t)
            wnx = jnp.where(m, nx, wnx)
            wny = jnp.where(m, ny, wny)
            wnz = jnp.where(m, nz, wnz)
            mat_id = jnp.where(m, _lookup(tri_mat, safe), mat_id)

        if has_sph:
            m = fam == 1
            safe = jnp.clip(idx, 0, scene.num_spheres - 1)
            cx, cy, cz = (_lookup(c, safe) for c in s_c)
            r = _lookup(s_r, safe)
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            dd = dx * dx + dy * dy + dz * dz
            bh = dx * ocx + dy * ocy + dz * ocz
            ct = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = jnp.maximum(bh * bh - dd * ct, 1e-12)
            sq = jnp.sqrt(disc)
            t0 = _safe_div(-bh - sq, dd)
            t1 = _safe_div(-bh + sq, dd)
            t_s = jnp.where(t0 > 0.0, t0, t1)
            t_s = jnp.where(m, jnp.clip(t_s, -1e6, 1e6), 0.0)
            t = jnp.where(m, t_s, t)
            wnx = jnp.where(m, ox + t_s * dx - cx, wnx)
            wny = jnp.where(m, oy + t_s * dy - cy, wny)
            wnz = jnp.where(m, oz + t_s * dz - cz, wnz)
            mat_id = jnp.where(m, _lookup(sph_mat, safe), mat_id)

        if has_pln:
            m = fam == 2
            safe = jnp.clip(idx, 0, scene.num_planes - 1)
            nx, ny, nz = (_lookup(c, safe) for c in p_n)
            doff = _lookup(p_d, safe)
            dn = dx * nx + dy * ny + dz * nz
            t_p = _safe_div(doff - (ox * nx + oy * ny + oz * nz), dn)
            t = jnp.where(m, jnp.clip(t_p, -1e6, 1e6), t)
            wnx = jnp.where(m, nx, wnx)
            wny = jnp.where(m, ny, wny)
            wnz = jnp.where(m, nz, wnz)
            mat_id = jnp.where(m, _lookup(pln_mat, safe), mat_id)

        hit = fam >= 0
        miss_now = active & ~hit

        # ------------------------------------------------------ sky on miss
        sky_t = dy * 0.5 + 0.5
        rr = jnp.where(miss_now, rr + cr + tr * (_WHITE[0] + (_BLUE[0] - _WHITE[0]) * sky_t), rr)
        rg = jnp.where(miss_now, rg + cg + tg * (_WHITE[1] + (_BLUE[1] - _WHITE[1]) * sky_t), rg)
        rb = jnp.where(miss_now, rb + cb + tb * (_WHITE[2] + (_BLUE[2] - _WHITE[2]) * sky_t), rb)
        active = active & hit

        # --------------------------------------------------- material fetch
        msafe = jnp.clip(mat_id, 0, n_mat - 1)
        alb_r, alb_g, alb_b = (_lookup(c, msafe) for c in m_alb)
        em_r, em_g, em_b = (_lookup(c, msafe) for c in m_em)
        ior = _lookup(m_ior, msafe)
        kind = _lookup(m_kind, msafe)

        cr = jnp.where(active, cr + tr * em_r, cr)
        cg = jnp.where(active, cg + tg * em_g, cg)
        cb = jnp.where(active, cb + tb * em_b, cb)

        # ---------------------------------------------------- hit geometry
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        inv_nl = _rsqrt_safe(wnx * wnx + wny * wny + wnz * wnz)
        nX, nY, nZ = wnx * inv_nl, wny * inv_nl, wnz * inv_nl
        inv_dl = _rsqrt_safe(dx * dx + dy * dy + dz * dz)
        iX, iY, iZ = dx * inv_dl, dy * inv_dl, dz * inv_dl

        cos_view = iX * nX + iY * nY + iZ * nZ
        flipped = cos_view > 0.0
        cos_in = jnp.abs(cos_view)
        nX = jnp.where(flipped, -nX, nX)
        nY = jnp.where(flipped, -nY, nY)
        nZ = jnp.where(flipped, -nZ, nZ)
        eta = jnp.where(flipped, ior, 1.0 / jnp.maximum(ior, 1e-8))

        # -------------------------------------------------------------- RNG
        u, v, w = rng_mod.uniform3(
            pixel, frame, salt_base + bounce * jnp.uint32(4)
        )

        phi = TWO_PI * u
        cos_t = 1.0 - 2.0 * v
        sin_t = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_t * cos_t))
        lamX = nX + sin_t * jnp.cos(phi)
        lamY = nY + sin_t * jnp.sin(phi)
        lamZ = nZ + cos_t

        refX = iX + 2.0 * cos_in * nX
        refY = iY + 2.0 * cos_in * nY
        refZ = iZ + 2.0 * cos_in * nZ

        cos_out_sqr = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
        cos_out = jnp.sqrt(jnp.maximum(1e-12, cos_out_sqr))
        r_perp = (eta * cos_in - cos_out) / (eta * cos_in + cos_out)
        r_par = (cos_in - eta * cos_out) / (cos_in + eta * cos_out)
        f_refl = 0.5 * (r_perp * r_perp + r_par * r_par)
        refl = jax.lax.stop_gradient((cos_out_sqr <= 0.0) | (w < f_refl))
        k = eta * cos_in - cos_out
        dieX = jnp.where(refl, refX, eta * iX + k * nX)
        dieY = jnp.where(refl, refY, eta * iY + k * nY)
        dieZ = jnp.where(refl, refZ, eta * iZ + k * nZ)
        die_off = jnp.where(refl, _EPSILON, -_EPSILON)

        is_lam = kind == 0
        is_mir = kind == 1

        out_dx = jnp.where(is_lam, lamX, jnp.where(is_mir, refX, dieX))
        out_dy = jnp.where(is_lam, lamY, jnp.where(is_mir, refY, dieY))
        out_dz = jnp.where(is_lam, lamZ, jnp.where(is_mir, refZ, dieZ))
        off = jnp.where(is_lam | is_mir, _EPSILON, die_off)

        ox = jnp.where(active, px + off * nX, ox)
        oy = jnp.where(active, py + off * nY, oy)
        oz = jnp.where(active, pz + off * nZ, oz)
        dx = jnp.where(active, out_dx, dx)
        dy = jnp.where(active, out_dy, dy)
        dz = jnp.where(active, out_dz, dz)
        tr = jnp.where(active, tr * alb_r, tr)
        tg = jnp.where(active, tg * alb_g, tg)
        tb = jnp.where(active, tb * alb_b, tb)
        return (ox, oy, oz, dx, dy, dz, tr, tg, tb,
                cr, cg, cb, rr, rg, rb, active), None

    zeros = jnp.zeros((n,), jnp.float32)
    ones = jnp.ones((n,), jnp.float32)
    init = (
        origin[:, 0], origin[:, 1], origin[:, 2],
        direction[:, 0], direction[:, 1], direction[:, 2],
        ones, ones, ones, zeros, zeros, zeros, zeros, zeros, zeros,
        jnp.ones((n,), bool),
    )
    xs = (fams, idxs, jnp.arange(nbounce, dtype=jnp.uint32))
    body = jax.checkpoint(step, prevent_cse=False) if remat else step
    carry, _ = jax.lax.scan(body, init, xs)
    (_, _, _, _, _, _, tr, tg, tb, cr, cg, cb, rr, rg, rb, active) = carry
    if style == "standard":
        rr = jnp.where(active, rr + cr, rr)
        rg = jnp.where(active, rg + cg, rg)
        rb = jnp.where(active, rb + cb, rb)
    return jnp.stack([rr, rg, rb], axis=-1)
