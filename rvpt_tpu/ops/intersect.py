"""Vectorized ray/primitive intersection.

Re-design of the reference's per-ray GLSL intersection library
(assets/shaders/intersection.glsl:133-357).  Instead of one ray against one
primitive inside a divergent loop, every test is phrased over a
``[rays, prims]`` block built from outer-product component broadcasts
(``d.n = dx*nx' + dy*ny' + dz*nz'``), so the metric-tensor triangle test
(reference: intersection.glsl:267-323) becomes elementwise work feeding a
masked min-reduction.  Large scenes stream triangle chunks through a
``lax.scan`` with a running (t, index) carry, which bounds the block at
``[rays, tri_chunk]`` instead of ``[N, T]``.

Differentiability: the winning primitive index is discrete and detached; the
differentiable intersection record is *recomputed* for the selected primitive
only (`isect_from_hit`), so gradients flow through the ``t, u, v`` solve and
normals without backpropagating through the argmin search.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import cross, vdot
from ..core.types import Isect, Ray
from ..scene import materials as mat_mod
from ..scene.scene import Scene

def _pdot(a, b):
    """Pairwise dot of [N,3] rays against [T,3] primitive vectors -> [N,T].

    Written as component broadcasts, not a matmul: it fuses into the
    downstream [N,T] elementwise work, stays exact float32 (a float32 dot
    may run in TF32 on a GPU), and is the same product chain the Triton
    search kernel (ops.search_triton) evaluates.
    """
    return (
        a[:, 0:1] * b[None, :, 0]
        + a[:, 1:2] * b[None, :, 1]
        + a[:, 2:3] * b[None, :, 2]
    )

# NumPy scalars, not jax Arrays: a jax Array constant captured inside a
# scan or while_loop body has broken a later, different jitted program in
# the same process ("Execution supplied N buffers but compiled program
# expected M"; jax 0.9).
INF = np.float32(np.inf)

# Primitive family codes used in hit records.
FAM_NONE = -1
FAM_TRI = 0
FAM_SPH = 1
FAM_PLN = 2

_DENOM_EPS = np.float32(1e-30)


def _min_and_first_index(t, axis):
    """(min t, index of first min) as two plain min-reductions with an iota
    select instead of argmin + take_along_axis; the Triton search kernel
    uses the same first-min rule, so both break ties identically.
    """
    tb = jnp.min(t, axis=axis)
    iota = jax.lax.broadcasted_iota(jnp.int32, t.shape, axis)
    first = jnp.min(
        jnp.where(t == jnp.expand_dims(tb, axis), iota, jnp.int32(2**30)),
        axis=axis,
    )
    return tb, first


def _safe_div(num, den):
    """num/den with sign-preserving clamp so 0-denominators give huge t
    (rejected by range tests) instead of NaNs that poison gradients."""
    den_safe = jnp.where(jnp.abs(den) < _DENOM_EPS, _DENOM_EPS, den)
    return num / den_safe


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------


def triangle_precompute(v0, v1, v2):
    """Per-triangle quantities reused across every ray tile.

    Mirrors the metric-tensor formulation of the reference
    (intersection.glsl:267-323): edges, geometric normal, and the adjoint of
    the 2x2 Gram matrix.
    """
    e0 = v1 - v0
    e1 = v2 - v0
    n = cross(e0, e1)
    g00 = vdot(e0, e0)
    g11 = vdot(e1, e1)
    g01 = vdot(e0, e1)
    inv_det = _safe_div(jnp.float32(1.0), g00 * g11 - g01 * g01)
    return dict(
        e0=e0,
        e1=e1,
        n=n,
        v0n=vdot(v0, n),
        v0e0=vdot(v0, e0),
        v0e1=vdot(v0, e1),
        g00=g00,
        g11=g11,
        g01=g01,
        inv_det=inv_det,
    )


def _tri_block_tuv(o, d, v0, pre):
    """t, u, v for every (ray, triangle) pair in a block.

    o, d: f32[N,3]; v0: f32[T,3]; pre: triangle_precompute output over [T].
    Returns f32[N,T] t, u, v.  Pairwise dots are component broadcasts (_pdot).
    """
    dn = _pdot(d, pre["n"])  # [N,T]
    on = _pdot(o, pre["n"])
    de0 = _pdot(d, pre["e0"])
    de1 = _pdot(d, pre["e1"])
    oe0 = _pdot(o, pre["e0"])
    oe1 = _pdot(o, pre["e1"])

    t = _safe_div(pre["v0n"][None, :] - on, dn)
    # p0 . e_k  where p0 = o + t d - v0, expanded so no [N,T,3] appears.
    b0 = oe0 + t * de0 - pre["v0e0"][None, :]
    b1 = oe1 + t * de1 - pre["v0e1"][None, :]
    u = pre["inv_det"][None, :] * (pre["g11"][None, :] * b0 - pre["g01"][None, :] * b1)
    v = pre["inv_det"][None, :] * (pre["g00"][None, :] * b1 - pre["g01"][None, :] * b0)
    return t, u, v


def _tri_block_best(o, d, v0, pre, mint, maxt):
    """Closest valid hit per ray within one triangle block: (t[N], col[N])."""
    t, u, v = _tri_block_tuv(o, d, v0, pre)
    valid = (mint < t) & (t < maxt) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
    t = jnp.where(valid, t, INF)
    tbest, col = _min_and_first_index(t, axis=1)
    return tbest, col


def closest_hit_triangles(
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    mint,
    maxt,
    tri_chunk: int = 2048,
):
    """Brute-force closest hit of N rays against T triangles.

    Returns (t[N] f32 — inf on miss, idx[N] i32 — -1 on miss).  This is the
    reference's brute-force path (intersection.glsl:708-752) and the plain
    reference every other search is compared against.  Triangle chunks
    stream through a scan with a running (t, idx) carry.
    """
    n_tri = v0.shape[0]
    if n_tri == 0:
        n = origin.shape[0]
        return jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32)

    mint = jnp.float32(mint)
    maxt = jnp.float32(maxt)

    if n_tri <= tri_chunk:
        pre = triangle_precompute(v0, v1, v2)
        tbest, col = _tri_block_best(origin, direction, v0, pre, mint, maxt)
        idx = jnp.where(jnp.isfinite(tbest), col, -1)
        return tbest, idx

    # Pad to a multiple of tri_chunk with degenerate triangles (zero normal ->
    # denominator clamp -> t huge -> never valid).
    pad = (-n_tri) % tri_chunk
    z = jnp.zeros((pad, 3), v0.dtype)
    v0p = jnp.concatenate([v0, z]).reshape(-1, tri_chunk, 3)
    v1p = jnp.concatenate([v1, z]).reshape(-1, tri_chunk, 3)
    v2p = jnp.concatenate([v2, z]).reshape(-1, tri_chunk, 3)

    n = origin.shape[0]

    def step(carry, chunk):
        t_run, i_run, base = carry
        cv0, cv1, cv2 = chunk
        pre = triangle_precompute(cv0, cv1, cv2)
        t_c, col = _tri_block_best(origin, direction, cv0, pre, mint, maxt)
        better = t_c < t_run
        t_run = jnp.where(better, t_c, t_run)
        i_run = jnp.where(better, base + col, i_run)
        return (t_run, i_run, base + tri_chunk), None

    init = (jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32), jnp.int32(0))
    (t_run, i_run, _), _ = jax.lax.scan(step, init, (v0p, v1p, v2p))
    return t_run, i_run


def any_hit_triangles(origin, direction, v0, v1, v2, mint, maxt, tri_chunk: int = 2048):
    """Boolean occlusion test (shadow rays): any valid hit in (mint, maxt)."""
    t, idx = closest_hit_triangles(origin, direction, v0, v1, v2, mint, maxt, tri_chunk)
    return idx >= 0


def triangle_isect_single(o, d, v0, v1, v2):
    """Differentiable t, u, v, normal for matched ray/triangle batches [N].

    Used to rebuild the intersection record for the winning triangle
    (the gradient path around the detached argmin).
    """
    e0 = v1 - v0
    e1 = v2 - v0
    n = cross(e0, e1)
    t = _safe_div(vdot(v0 - o, n), vdot(d, n))
    p0 = o + t[..., None] * d - v0
    b0 = vdot(p0, e0)
    b1 = vdot(p0, e1)
    g00 = vdot(e0, e0)
    g11 = vdot(e1, e1)
    g01 = vdot(e0, e1)
    inv_det = _safe_div(jnp.float32(1.0), g00 * g11 - g01 * g01)
    u = inv_det * (g11 * b0 - g01 * b1)
    v = inv_det * (g00 * b1 - g01 * b0)
    return t, u, v, n


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------


def closest_hit_spheres(origin, direction, center, radius, mint, maxt):
    """Closest hit of N rays against S spheres: (t[N], idx[N]).

    Standard stabilized quadratic; nearest root inside (mint, maxt), far root
    if the near one is behind ``mint`` (ray starting inside the sphere).
    """
    n_sph = center.shape[0]
    if n_sph == 0:
        n = origin.shape[0]
        return jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32)
    mint = jnp.float32(mint)
    maxt = jnp.float32(maxt)

    # [S, N] orientation: the reduction runs over the short primitive axis.
    cx, cy, cz = center[:, 0:1], center[:, 1:2], center[:, 2:3]  # [S,1]
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]  # [N]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    ocx = ox[None, :] - cx
    ocy = oy[None, :] - cy
    ocz = oz[None, :] - cz  # [S,N]
    dd = (dx * dx + dy * dy + dz * dz)[None, :]
    # |o - c + t d|^2 = r^2  ->  dd t^2 + 2 d.(o-c) t + |o-c|^2 - r^2 = 0
    b_half = dx[None, :] * ocx + dy[None, :] * ocy + dz[None, :] * ocz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[:, None]
    disc = b_half * b_half - dd * c_term
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = _safe_div(-b_half - sq, dd)
    t1 = _safe_div(-b_half + sq, dd)
    t_near = jnp.where((t0 > mint) & (t0 < maxt), t0, INF)
    t_far = jnp.where((t1 > mint) & (t1 < maxt), t1, INF)
    t = jnp.where(disc > 0.0, jnp.minimum(t_near, t_far), INF)
    tbest, row = _min_and_first_index(t, axis=0)
    idx = jnp.where(jnp.isfinite(tbest), row, -1)
    return tbest, idx


def sphere_isect_single(o, d, center, radius, mint):
    """Differentiable t for matched ray/sphere batches [N] (nearest valid
    root recomputed; the same near-root-first rule as the search phase)."""
    oc = o - center
    dd = vdot(d, d)
    b_half = vdot(d, oc)
    c_term = vdot(oc, oc) - radius * radius
    # The epsilon floor keeps sqrt differentiable on masked miss lanes (the
    # where-NaN trap: d/dx sqrt(0) = inf poisons gradients through selects).
    disc = jnp.maximum(b_half * b_half - dd * c_term, 1e-12)
    sq = jnp.sqrt(disc)
    t0 = _safe_div(-b_half - sq, dd)
    t1 = _safe_div(-b_half + sq, dd)
    t = jnp.where(t0 > mint, t0, t1)
    return t


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------


def closest_hit_planes(origin, direction, normal, d_off, mint, maxt):
    """Closest hit of N rays against P planes <p,n> = d
    (reference: intersection.glsl:100-129): (t[N], idx[N])."""
    n_pln = normal.shape[0]
    if n_pln == 0:
        n = origin.shape[0]
        return jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32)
    mint = jnp.float32(mint)
    maxt = jnp.float32(maxt)
    # [P, N] orientation (see closest_hit_spheres).
    nx, ny, nz = normal[:, 0:1], normal[:, 1:2], normal[:, 2:3]  # [P,1]
    on = nx * origin[None, :, 0] + ny * origin[None, :, 1] + nz * origin[None, :, 2]
    dn = nx * direction[None, :, 0] + ny * direction[None, :, 1] + nz * direction[None, :, 2]
    t = _safe_div(d_off[:, None] - on, dn)
    t = jnp.where((t > mint) & (t < maxt), t, INF)
    tbest, row = _min_and_first_index(t, axis=0)
    idx = jnp.where(jnp.isfinite(tbest), row, -1)
    return tbest, idx


def plane_isect_single(o, d, normal, d_off):
    t = _safe_div(d_off - vdot(o, normal), vdot(d, normal))
    return t


# ---------------------------------------------------------------------------
# AABB slab test (BVH building block)
# ---------------------------------------------------------------------------


def intersect_aabb(origin, direction, box_min, box_max, mint, maxt):
    """Slab test, fp32 (the reference accidentally used fp64 temporaries,
    intersection.glsl:349-350; fp32 with min/max ordering is sufficient).
    Broadcasts over matching batch shapes."""
    inv_d = _safe_div(jnp.float32(1.0), direction)
    f = (box_max - origin) * inv_d
    n = (box_min - origin) * inv_d
    t1 = jnp.min(jnp.maximum(f, n), axis=-1)
    t0 = jnp.max(jnp.minimum(f, n), axis=-1)
    t0 = jnp.maximum(t0, mint)
    t1 = jnp.minimum(t1, maxt)
    return t1 >= t0


# ---------------------------------------------------------------------------
# Whole-scene intersection
# ---------------------------------------------------------------------------


def closest_hit_scene(scene: Scene, ray: Ray, mint, maxt, tri_chunk: int = 2048):
    """Discrete closest-hit search across all primitive families.

    Returns (family[N] i32, idx[N] i32, t[N] f32) with family/idx detached
    from the autodiff graph (they select, they do not differentiate).  The
    triangle search runs on the platform's route (``ops.route``).
    """
    from . import route

    o, d = ray.origin, ray.direction
    search = route.triangle_search(scene.bvh is not None)
    if scene.num_triangles == 0 or search == route.DENSE:
        t_tri, i_tri = closest_hit_triangles(
            o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2, mint, maxt, tri_chunk
        )
    elif search == route.TRAVERSE:
        from . import traverse

        t_tri, i_tri = traverse.closest_hit_bvh(scene, scene.bvh, o, d, mint, maxt)
    else:
        from .search_triton import closest_hit_triangles_triton

        # Detached inputs keep the non-differentiable kernel off the tangent
        # path; isect_from_hit rebuilds the differentiable record.
        sg = jax.lax.stop_gradient
        t_tri, i_tri = closest_hit_triangles_triton(
            sg(o), sg(d), sg(scene.tri_v0), sg(scene.tri_v1), sg(scene.tri_v2),
            mint, maxt, interpret=False,
        )
    t_sph, i_sph = closest_hit_spheres(o, d, scene.sph_center, scene.sph_radius, mint, maxt)
    t_pln, i_pln = closest_hit_planes(o, d, scene.pln_normal, scene.pln_d, mint, maxt)

    t = t_tri
    fam = jnp.where(jnp.isfinite(t_tri), FAM_TRI, FAM_NONE).astype(jnp.int32)
    idx = i_tri
    better = t_sph < t
    t = jnp.where(better, t_sph, t)
    fam = jnp.where(better, FAM_SPH, fam)
    idx = jnp.where(better, i_sph, idx)
    better = t_pln < t
    t = jnp.where(better, t_pln, t)
    fam = jnp.where(better, FAM_PLN, fam)
    idx = jnp.where(better, i_pln, idx)

    fam = jax.lax.stop_gradient(fam)
    idx = jax.lax.stop_gradient(idx)
    return fam, idx, t


def isect_from_hit(
    scene: Scene, ray: Ray, fam: jnp.ndarray, idx: jnp.ndarray, mint=1e-2
) -> Isect:
    """Differentiable intersection record for an already-selected primitive.

    Rebuilds t/pos/normal/uv from gathered primitive data so that gradients
    flow into vertices, sphere params, plane params, and the ray itself.
    Miss lanes (fam == FAM_NONE) produce t=inf, zero pos/normal — the same
    convention as the reference's intersect_scene
    (intersection.glsl:489-517).
    """
    o, d = ray.origin, ray.direction
    n_rays = o.shape[0]
    zero3 = jnp.zeros((n_rays, 3), jnp.float32)

    t = jnp.full((n_rays,), INF)
    normal = zero3
    uv = jnp.zeros((n_rays, 2), jnp.float32)
    mat = jnp.full((n_rays,), -1, jnp.int32)

    # NaN-hygiene: every per-family t is clamped to a sane value on masked
    # lanes BEFORE any further arithmetic.  Garbage t values (clamped-
    # denominator divisions can reach ~1e36) stay finite in the primal but
    # their *partials* overflow f32, and a where() only zeroes cotangents —
    # 0 * inf = NaN then poisons the whole backward pass (observed under
    # lax.scan, where DCE can't prune the dead branch like it can unrolled).
    def _mask_t(m, t_raw):
        return jnp.where(m, jnp.clip(t_raw, -1e6, 1e6), 0.0)

    if scene.num_triangles > 0:
        safe = jnp.clip(idx, 0, scene.num_triangles - 1)
        v0 = scene.tri_v0[safe]
        v1 = scene.tri_v1[safe]
        v2 = scene.tri_v2[safe]
        t_t, u_t, v_t, n_t = triangle_isect_single(o, d, v0, v1, v2)
        m = fam == FAM_TRI
        t = jnp.where(m, t_t, t)
        normal = jnp.where(m[:, None], n_t, normal)
        uv = jnp.where(m[:, None], jnp.stack([u_t, v_t], axis=-1), uv)
        mat = jnp.where(m, scene.tri_mat[safe], mat)

    if scene.num_spheres > 0:
        safe = jnp.clip(idx, 0, scene.num_spheres - 1)
        c = scene.sph_center[safe]
        r = scene.sph_radius[safe]
        t_s = sphere_isect_single(o, d, c, r, jnp.float32(mint))
        m = fam == FAM_SPH
        t_s_safe = _mask_t(m, t_s)
        pos_s = o + t_s_safe[:, None] * d
        t = jnp.where(m, t_s, t)
        normal = jnp.where(m[:, None], pos_s - c, normal)
        mat = jnp.where(m, scene.sph_mat[safe], mat)

    if scene.num_planes > 0:
        safe = jnp.clip(idx, 0, scene.num_planes - 1)
        pn = scene.pln_normal[safe]
        pd = scene.pln_d[safe]
        t_p = plane_isect_single(o, d, pn, pd)
        m = fam == FAM_PLN
        t = jnp.where(m, t_p, t)
        normal = jnp.where(m[:, None], pn, normal)
        mat = jnp.where(m, scene.pln_mat[safe], mat)

    hit = jnp.isfinite(t)
    t_for_pos = jnp.where(hit, jnp.clip(t, -1e6, 1e6), 0.0)
    pos = jnp.where(hit[:, None], o + t_for_pos[:, None] * d, zero3)
    # Reference intersect_scene normalizes the stored normal and zeroes it on
    # miss (intersection.glsl:511-513); integrators consume it directly.
    from ..core.math import normalize as _normalize

    normal = jnp.where(hit[:, None], _normalize(normal), zero3)
    return Isect(t=t, pos=pos, normal=normal, uv=uv, prim=idx, mat=mat)


def intersect_scene(scene: Scene, ray: Ray, mint, maxt, tri_chunk: int = 2048) -> Isect:
    """Search + differentiable rebuild, the one-call scene intersector."""
    fam, idx, _ = closest_hit_scene(scene, ray, mint, maxt, tri_chunk)
    return isect_from_hit(scene, ray, fam, idx, mint)


def occluded(scene: Scene, ray: Ray, mint, maxt, tri_chunk: int = 2048) -> jnp.ndarray:
    """Boolean shadow query across every family
    (reference: intersect_scene_any, intersection.glsl:467-485)."""
    fam, _, _ = closest_hit_scene(scene, ray, mint, maxt, tri_chunk)
    return fam != FAM_NONE
