"""Multi-chip rendering via shard_map over a (tiles, spp) mesh.

Design (SURVEY.md §5 "distributed communication backend"):
  * Film rows/tiles are sharded over the ``tiles`` axis — pure data
    parallelism, zero cross-chip traffic during tracing because the scene and
    materials are replicated on every chip (they are tiny; the reference
    re-uploads them per frame, src/rvpt/rvpt.cpp:124-126).
  * The ``spp`` axis shards Monte-Carlo samples of the *same* pixels; ranks
    render decorrelated sample sets and a ``pmean`` combines them —
    the path-tracing analog of sequence parallelism.
  * Gradients of replicated scene parameters are all-reduced automatically:
    shard_map's transpose inserts a psum for replicated inputs, so
    ``jax.grad`` of a sharded loss needs no hand-written collectives.

RNG streams are keyed by *global* pixel id, so the sharded image is
bit-identical to the single-device one (tested).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import FilmConfig, RenderSettings
from ..ops import film as film_ops
from ..render import _pixel_grid, render_pixels
from .mesh import SPP_AXIS, TILE_AXIS


def _padded_grid(cfg: FilmConfig, n_tiles: int):
    """Global pixel-coordinate arrays padded to a multiple of n_tiles.

    Padding lanes replicate pixel 0 (their results are dropped on reshape) so
    any film size divides the mesh; for best balance keep H*W % n_tiles == 0.
    """
    pixel, xs, ys = _pixel_grid(cfg)
    n = pixel.shape[0]
    pad = (-n) % n_tiles
    if pad:
        pixel = jnp.concatenate([pixel, pixel[:pad]])
        xs = jnp.concatenate([xs, xs[:pad]])
        ys = jnp.concatenate([ys, ys[:pad]])
    return pixel, xs, ys, n


def render_sample_sharded(scene, camera, settings: RenderSettings,
                          cfg: FilmConfig, frame, mesh):
    """Full-film sample image rendered across the mesh -> f32[3,H,W].

    Effective samples per pixel = settings.aa * mesh.shape[spp].
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    pixel, xs, ys, n = _padded_grid(cfg, n_tiles)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS), P(), P(), P()),
        out_specs=P(None, TILE_AXIS),
        # The bounce-loop scan carries are initialized from literals; the
        # varying-manual-axes checker would reject them (they only become
        # varying after the first combine with ray data), so use the legacy
        # unchecked semantics.
        check_vma=False,
    )
    def tile_render(pixel, xs, ys, scene, camera, frame):
        rank = jax.lax.axis_index(SPP_AXIS)
        sampled = render_pixels(
            scene, camera, settings, cfg, frame, pixel, xs, ys,
            aa_offset=rank.astype(jnp.uint32) * jnp.uint32(settings.aa),
        )
        if n_spp > 1:
            sampled = jax.lax.pmean(sampled, SPP_AXIS)
        return sampled.T  # [3, n_local]: channels-first film layout

    frame = jnp.asarray(frame, jnp.uint32)
    sampled = tile_render(pixel, xs, ys, scene, camera, frame)
    return sampled[:, :n].reshape(3, cfg.height, cfg.width)


def render_frame_sharded(scene, camera, settings, cfg, film, dirty, mesh):
    """Sharded sample + EMA accumulate (film itself stays row-sharded if the
    caller placed it so; the update is elementwise) — the reference's steady
    loop (rvpt.cpp:346-404) over the mesh."""
    frame = jnp.where(jnp.asarray(dirty), jnp.uint32(0), film.frame)
    sample = render_sample_sharded(scene, camera, settings, cfg, frame, mesh)
    new_film = film_ops.accumulate(film, sample, dirty)
    return new_film, new_film.accum


def make_render_fn(scene, camera, settings, cfg, mesh):
    """Jitted closure for the steady-state sharded frame loop."""

    @partial(jax.jit, donate_argnames=("film",))
    def step(scene, camera, film, dirty):
        return render_frame_sharded(scene, camera, settings, cfg, film,
                                    dirty, mesh)

    return step
