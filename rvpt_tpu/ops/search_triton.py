"""Pallas-Triton closest-hit search: N rays against T triangles on the GPU.

The XLA search (``ops.intersect.closest_hit_triangles``) builds
``[rays, tri_chunk]`` t/u/v blocks and reduces them with two min passes, so
each block makes a round trip through device memory.  This kernel keeps a
tile of precomputed triangle scalars in registers/L1 and the running
``(t, index)`` per ray in registers: only rays go in and ``(t, index)``
comes out.  The per-pair math is the same metric-tensor test
(``triangle_precompute`` / ``_tri_block_tuv``; reference
intersection.glsl:267-323) with the same first-minimum tie rule, so both
searches pick the same triangle up to fma rounding.

Layout: one program owns ``RAY_BLOCK`` rays (a power of two, as Triton
requires) and loops over ``TRI_TILE``-triangle tiles of a packed
``f32[16, T_pad]`` table; each tile is a ``[TRI_TILE, RAY_BLOCK]``
elementwise block reduced over its triangle axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .intersect import triangle_precompute

# Chosen by a sweep on an H100 80GB HBM3 (700 W limit): mesh-20482 against
# 2.07 M rays, block x tile x warps over {64,128,256} x {8,16,32} x {4,8};
# the best three were within 3% of each other (PERF.md, PR 1).
RAY_BLOCK = 256   # rays per program
TRI_TILE = 8      # triangles per inner-loop step
NUM_WARPS = 4
NUM_STAGES = 2

_DENOM_EPS = 1e-30  # python floats: jnp scalars would be captured constants
_NO_INDEX = 2**30

# Row order of the packed triangle table.
FIELDS = (
    "nx", "ny", "nz", "e0x", "e0y", "e0z", "e1x", "e1y", "e1z",
    "v0n", "v0e0", "v0e1", "g00", "g11", "g01", "inv_det",
)


def pack_triangles(v0, v1, v2, tile: int = TRI_TILE):
    """f32[16, T_pad] per-triangle scalars, T_pad a multiple of ``tile``.

    Padding columns are all zero: a zero normal clamps the denominator, so
    t = 0 / eps = 0 fails ``mint < t`` for every mint >= 0 and a padding
    triangle never wins (the XLA search pads the same way)."""
    pre = triangle_precompute(v0, v1, v2)
    cols = {
        "nx": pre["n"][:, 0], "ny": pre["n"][:, 1], "nz": pre["n"][:, 2],
        "e0x": pre["e0"][:, 0], "e0y": pre["e0"][:, 1], "e0z": pre["e0"][:, 2],
        "e1x": pre["e1"][:, 0], "e1y": pre["e1"][:, 1], "e1z": pre["e1"][:, 2],
    }
    cols.update({k: pre[k] for k in FIELDS[9:]})
    table = jnp.stack([cols[k].astype(jnp.float32) for k in FIELDS])
    return jnp.pad(table, ((0, 0), (0, (-table.shape[1]) % tile)))


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tri_ref,
            t_ref, i_ref, *, mint, maxt, n_tiles, tile, block):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    rows = jax.lax.broadcasted_iota(jnp.int32, (tile, block), 0)

    def step(c, carry):
        t_best, i_best = carry
        sl = pl.ds(c * tile, tile)
        f = {k: tri_ref[r, sl][:, None] for r, k in enumerate(FIELDS)}

        dn = f["nx"] * dx + f["ny"] * dy + f["nz"] * dz      # [tile, block]
        on = f["nx"] * ox + f["ny"] * oy + f["nz"] * oz
        de0 = f["e0x"] * dx + f["e0y"] * dy + f["e0z"] * dz
        de1 = f["e1x"] * dx + f["e1y"] * dy + f["e1z"] * dz
        oe0 = f["e0x"] * ox + f["e0y"] * oy + f["e0z"] * oz
        oe1 = f["e1x"] * ox + f["e1y"] * oy + f["e1z"] * oz

        dn = jnp.where(jnp.abs(dn) < _DENOM_EPS, _DENOM_EPS, dn)
        t = (f["v0n"] - on) / dn
        b0 = oe0 + t * de0 - f["v0e0"]
        b1 = oe1 + t * de1 - f["v0e1"]
        u = f["inv_det"] * (f["g11"] * b0 - f["g01"] * b1)
        v = f["inv_det"] * (f["g00"] * b1 - f["g01"] * b0)
        valid = (mint < t) & (t < maxt) & (u > 0.0) & (v > 0.0) & (u + v < 1.0)
        t = jnp.where(valid, t, jnp.inf)

        t_min = jnp.min(t, axis=0)                               # [block]
        first = jnp.min(jnp.where(t == t_min[None, :], rows, _NO_INDEX),
                        axis=0)
        better = t_min < t_best                # strict: earlier tiles win ties
        return (jnp.where(better, t_min, t_best),
                jnp.where(better, c * tile + first, i_best))

    init = (jnp.full((block,), jnp.inf, jnp.float32),
            jnp.full((block,), -1, jnp.int32))
    t_best, i_best = jax.lax.fori_loop(0, n_tiles, step, init)
    t_ref[...] = t_best
    i_ref[...] = i_best


@functools.partial(
    jax.jit, static_argnames=("mint", "maxt", "interpret", "block", "tile"))
def _search(comps, table, *, mint, maxt, interpret, block, tile):
    n_pad = comps[0].shape[0]
    n_tiles = table.shape[1] // tile
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_kernel, mint=mint, maxt=maxt, n_tiles=n_tiles,
                          tile=tile, block=block),
        grid=(n_pad // block,),
        in_specs=[ray_spec] * 6 + [pl.BlockSpec(table.shape, lambda i: (0, 0))],
        out_specs=(ray_spec, ray_spec),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="closest_hit_triangles_triton",
    )(*comps, table)


def closest_hit_triangles_triton(origin, direction, v0, v1, v2, mint, maxt, *,
                                 interpret: bool):
    """Closest hit of N rays against T triangles: (t[N] f32, inf on miss;
    idx[N] i32, -1 on miss) — the contract of
    ``ops.intersect.closest_hit_triangles``.  Not differentiable: callers
    pass detached rays and rebuild the record with ``isect_from_hit``.

    ``mint``/``maxt`` must be concrete (they are baked into the kernel).
    ``interpret=True`` runs the kernel in the Pallas interpreter (the CPU
    tests); on the GPU it compiles through Triton."""
    n = origin.shape[0]
    n_tri = v0.shape[0]
    if n_tri == 0:
        return jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32)
    block, tile = RAY_BLOCK, TRI_TILE
    pad = (-n) % block
    comps = tuple(
        jnp.pad(x.astype(jnp.float32), (0, pad))
        for x in (origin[:, 0], origin[:, 1], origin[:, 2],
                  direction[:, 0], direction[:, 1], direction[:, 2]))
    table = pack_triangles(v0, v1, v2, tile)
    t, idx = _search(comps, table, mint=float(mint), maxt=float(maxt),
                     interpret=interpret, block=block, tile=tile)
    t, idx = t[:n], idx[:n]
    miss = (idx < 0) | (idx >= n_tri)
    return jnp.where(miss, jnp.inf, t), jnp.where(miss, -1, idx)
