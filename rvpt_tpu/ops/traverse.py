"""BVH traversal, vectorized over ray batches.

Vectorized re-design of the reference's per-thread stack walk
(assets/shaders/intersection.glsl:361-463): every ray keeps its own 64-entry
stack in a ``[N, 64]`` array and all rays advance in lockstep inside one
``lax.while_loop`` — lanes that finish early idle behind a mask until the
whole batch converges (the SIMT execution model made explicit).  Leaf
primitive loops run as a masked fixed-trip loop over the builder's maximum
leaf size (2-8 prims, bvh_builder.h:45-50).

All node ids / stack entries are int32 with sentinel -1 (the reference uses
u32 with ~0, intersection.glsl:371; int32 avoids cross-backend unsigned
promotion hazards).

This is the CPU search route for BVH scenes (ops.route); on the GPU it has
not been measured yet.  ``closest_hit_bvh`` matches
``closest_hit_triangles`` results exactly (tested on random scenes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import INF, _safe_div, triangle_isect_single

STACK_DEPTH = 64  # reference: intersection.glsl:363
# Bottom-of-stack marker (reference uses ~0).  A Python int: a jax Array
# constant captured in the while_loop body broke a later, different jitted
# program in the same process (see ops.intersect.INF).
SENTINEL = -1


def closest_hit_bvh(scene, bvh, origin, direction, mint, maxt):
    """Closest triangle hit via BVH: returns (t[N] f32 — inf on miss,
    idx[N] i32 — -1 on miss, indices into the *leaf-ordered* triangle
    arrays)."""
    n = origin.shape[0]
    mint = jnp.float32(mint)
    maxt = jnp.float32(maxt)
    max_leaf = int(bvh.max_leaf)
    n_tri = scene.tri_v0.shape[0]

    node_first = bvh.first.astype(jnp.int32)
    node_count = bvh.count.astype(jnp.int32)

    inv_d = _safe_div(jnp.float32(1.0), direction)  # [N,3], reused every node
    lane = jnp.arange(n)

    def aabb_hit(bmin, bmax, t_best):
        f = (bmax - origin) * inv_d
        nr = (bmin - origin) * inv_d
        t1 = jnp.min(jnp.maximum(f, nr), axis=-1)
        t0 = jnp.max(jnp.minimum(f, nr), axis=-1)
        return jnp.minimum(t1, t_best) >= jnp.maximum(t0, mint)

    def cond(state):
        done = state[-1]
        return ~jnp.all(done)

    def body(state):
        node, stack, ptr, t_best, i_best, done = state
        nsafe = jnp.clip(node, 0, node_first.shape[0] - 1)
        first = node_first[nsafe]
        count = node_count[nsafe]
        bmin = bvh.bmin[nsafe]
        bmax = bvh.bmax[nsafe]

        box_hit = aabb_hit(bmin, bmax, t_best) & ~done
        is_leaf = count > 0

        # --- leaf: masked fixed-trip loop over the leaf's triangles.
        def leaf_body(k, carry):
            t_b, i_b = carry
            tri = jnp.clip(first + k, 0, n_tri - 1)
            active = box_hit & is_leaf & (k < count)
            t, u, v, _ = triangle_isect_single(
                origin,
                direction,
                scene.tri_v0[tri],
                scene.tri_v1[tri],
                scene.tri_v2[tri],
            )
            valid = (
                active
                & (mint < t)
                & (t < jnp.minimum(t_b, maxt))
                & (u > 0.0)
                & (v > 0.0)
                & (u + v < 1.0)
            )
            t_b = jnp.where(valid, t, t_b)
            i_b = jnp.where(valid, tri, i_b)
            return t_b, i_b

        t_best, i_best = jax.lax.fori_loop(0, max_leaf, leaf_body, (t_best, i_best))

        # --- interior hit: descend into left child, push the right sibling.
        descend = box_hit & ~is_leaf
        push_val = jnp.where(descend, first + 1, stack[lane, jnp.clip(ptr, 0, STACK_DEPTH - 1)])
        new_stack = stack.at[lane, jnp.clip(ptr, 0, STACK_DEPTH - 1)].set(push_val)
        new_ptr = jnp.where(descend, ptr + 1, ptr)

        # --- miss or finished leaf: pop.
        pop = ~done & ~descend
        pop_ptr = jnp.maximum(new_ptr - 1, 0)
        popped = new_stack[lane, pop_ptr]
        node = jnp.where(descend, first, jnp.where(pop, popped, node))
        new_ptr = jnp.where(pop, pop_ptr, new_ptr)
        done = done | (pop & (popped == SENTINEL))
        return node, new_stack, new_ptr, t_best, i_best, done

    stack = jnp.full((n, STACK_DEPTH), SENTINEL, jnp.int32)
    state = (
        jnp.zeros((n,), jnp.int32),  # current node = root
        stack,
        jnp.ones((n,), jnp.int32),  # ptr = 1: slot 0 holds the sentinel
        jnp.full((n,), INF),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), bool),
    )
    _, _, _, t_best, i_best, _ = jax.lax.while_loop(cond, body, state)
    i_best = jnp.where(jnp.isfinite(t_best), i_best, -1)
    return t_best, i_best


def any_hit_bvh(scene, bvh, origin, direction, mint, maxt):
    """Occlusion query with per-lane early exit: a lane marks itself done on
    its FIRST valid hit (the reference's intersect_bvh_any early return,
    intersection.glsl:417-463) — in the lockstep model that just means the
    lane idles until the batch converges, but it stops expanding nodes."""
    n = origin.shape[0]
    mint = jnp.float32(mint)
    maxt = jnp.float32(maxt)
    max_leaf = int(bvh.max_leaf)
    n_tri = scene.tri_v0.shape[0]
    node_first = bvh.first.astype(jnp.int32)
    node_count = bvh.count.astype(jnp.int32)
    inv_d = _safe_div(jnp.float32(1.0), direction)
    lane = jnp.arange(n)

    def aabb_hit(bmin, bmax):
        f = (bmax - origin) * inv_d
        nr = (bmin - origin) * inv_d
        t1 = jnp.min(jnp.maximum(f, nr), axis=-1)
        t0 = jnp.max(jnp.minimum(f, nr), axis=-1)
        return jnp.minimum(t1, maxt) >= jnp.maximum(t0, mint)

    def cond(state):
        return ~jnp.all(state[-1])

    def body(state):
        node, stack, ptr, found, done = state
        nsafe = jnp.clip(node, 0, node_first.shape[0] - 1)
        first = node_first[nsafe]
        count = node_count[nsafe]
        box_hit = aabb_hit(bvh.bmin[nsafe], bvh.bmax[nsafe]) & ~done
        is_leaf = count > 0

        def leaf_body(k, fnd):
            tri = jnp.clip(first + k, 0, n_tri - 1)
            active = box_hit & is_leaf & (k < count) & ~fnd
            t, u, v, _ = triangle_isect_single(
                origin, direction,
                scene.tri_v0[tri], scene.tri_v1[tri], scene.tri_v2[tri],
            )
            valid = (
                active & (mint < t) & (t < maxt)
                & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
            )
            return fnd | valid

        found = jax.lax.fori_loop(0, max_leaf, leaf_body, found)
        done = done | found

        descend = box_hit & ~is_leaf & ~done
        push_val = jnp.where(
            descend, first + 1, stack[lane, jnp.clip(ptr, 0, STACK_DEPTH - 1)]
        )
        new_stack = stack.at[lane, jnp.clip(ptr, 0, STACK_DEPTH - 1)].set(push_val)
        new_ptr = jnp.where(descend, ptr + 1, ptr)
        pop = ~done & ~descend
        pop_ptr = jnp.maximum(new_ptr - 1, 0)
        popped = new_stack[lane, pop_ptr]
        node = jnp.where(descend, first, jnp.where(pop, popped, node))
        new_ptr = jnp.where(pop, pop_ptr, new_ptr)
        done = done | (pop & (popped == SENTINEL))
        return node, new_stack, new_ptr, found, done

    state = (
        jnp.zeros((n,), jnp.int32),
        jnp.full((n, STACK_DEPTH), SENTINEL, jnp.int32),
        jnp.ones((n,), jnp.int32),
        jnp.zeros((n,), bool),
        jnp.zeros((n,), bool),
    )
    _, _, _, found, _ = jax.lax.while_loop(cond, body, state)
    return found
