"""Top-level frame rendering: the jitted analog of the reference's compute
megakernel dispatch (assets/shaders/compute_pass.comp:121-167 +
src/rvpt/rvpt.cpp:1005-1039).

One call renders the full film: pixel-grid generation, per-sample jitter,
camera ray generation, integrator evaluation (with the reference's
split-screen up-to-4-way comparison), AA averaging, and the temporal EMA
update — all one XLA program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .config import FilmConfig, RenderSettings
from .core import rng
from .models import camera as camera_mod
from .models.integrators import AA_STRIDE, eval_integrator
from .ops import film as film_ops

_JITTER_SITE = 0
_INTEGRATOR_SITE = 16


def _pixel_grid(cfg: FilmConfig):
    """Flat pixel ids and integer coords; id = x + y*W matches the reference's
    seeding index (assets/shaders/util.glsl:35) so RNG streams are stable
    under any sharding of the film."""
    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.uint32),
        jnp.arange(cfg.width, dtype=jnp.uint32),
        indexing="ij",
    )
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    pixel = xs + ys * jnp.uint32(cfg.width)
    return pixel, xs, ys


def _mode_masks(settings: RenderSettings, xs, ys, cfg: FilmConfig):
    """Split-screen quadrant selection (compute_pass.comp:134-144)."""
    sx, sy = settings.split_ratio
    px = xs.astype(jnp.float32) / cfg.width
    py = ys.astype(jnp.float32) / cfg.height
    bottom = py > sy
    right_t = px > sx
    right_b = ~(px < sx)
    tl, tr, bl, br = settings.modes()
    mode_of_pixel = jnp.where(
        bottom,
        jnp.where(right_b, br, bl),
        jnp.where(right_t, tr, tl),
    )
    return mode_of_pixel


def jittered_camera_rays(camera, cfg: FilmConfig, pixel, xs, ys, frame,
                         salt0):
    """AA-jittered camera rays for a pixel batch — THE jitter convention
    (RNG site, y flip, reciprocal film scale) shared by the display path and
    the hit-record gradient path, so their images stay bit-identical."""
    ju, jv = rng.uniform2(pixel, frame, salt0 + jnp.uint32(_JITTER_SITE))
    # Jittered film coordinates, y flipped (compute_pass.comp:153-154).
    cx = (xs.astype(jnp.float32) + ju) * (1.0 / cfg.width)
    cy = 1.0 - (ys.astype(jnp.float32) + jv) * (1.0 / cfg.height)
    return camera_mod.generate_rays(camera, cx, cy)


def render_pixels(
    scene,
    camera,
    settings: RenderSettings,
    cfg: FilmConfig,
    frame,
    pixel,
    xs,
    ys,
    aa_offset=0,
):
    """Render an arbitrary batch of pixels -> f32[n,3] samples.

    This is the shard-local work unit: callers hand in (pixel ids, x, y)
    arrays — the full film (render_sample) or one tile of it
    (parallel.sharded) — and RNG streams depend only on the *global* pixel id,
    so any sharding produces bit-identical images.  ``aa_offset`` offsets the
    AA sample index (used to decorrelate spp-parallel ranks).
    """
    frame = jnp.asarray(frame, jnp.uint32)
    unique_modes = sorted(set(settings.modes()))
    n = pixel.shape[0]

    sampled = jnp.zeros((n, 3), jnp.float32)
    for i in range(settings.aa):
        salt0 = (jnp.uint32(i) + jnp.asarray(aa_offset, jnp.uint32)) * jnp.uint32(
            AA_STRIDE
        )
        ray = jittered_camera_rays(camera, cfg, pixel, xs, ys, frame, salt0)

        salt_base = salt0 + _INTEGRATOR_SITE
        if len(unique_modes) == 1:
            col = eval_integrator(
                unique_modes[0], scene, ray, pixel, frame, settings, salt_base
            )
        else:
            mode_of_pixel = _mode_masks(settings, xs, ys, cfg)
            col = jnp.zeros((n, 3), jnp.float32)
            for m in unique_modes:
                cm = eval_integrator(m, scene, ray, pixel, frame, settings, salt_base)
                col = jnp.where((mode_of_pixel == m)[:, None], cm, col)
        sampled = sampled + col

    return sampled / settings.aa


def render_sample_chw(scene, camera, settings: RenderSettings, cfg: FilmConfig, frame):
    """Render one frame's sample image f32[3,H,W] (pre-accumulation).

    Channels-first is the film layout (see ops.film docstring); this is
    the function the film/EMA path and benchmarks use.

    ``frame`` is a traced u32 — it seeds the stateless RNG exactly as the
    reference seeds per-pixel xorshift with wang_hash(pixel)+frame
    (util.glsl:35-36), so frame-to-frame samples decorrelate and a film reset
    replays the same sequence.
    """
    pixel, xs, ys = _pixel_grid(cfg)
    sampled = render_pixels(scene, camera, settings, cfg, frame, pixel, xs, ys)
    return sampled.T.reshape(3, cfg.height, cfg.width)


def render_sample(scene, camera, settings: RenderSettings, cfg: FilmConfig, frame):
    """Render one frame's sample image f32[H,W,3] (display layout)."""
    return jnp.moveaxis(render_sample_chw(scene, camera, settings, cfg, frame), 0, -1)


def render_frame(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                 film: film_ops.Film, dirty):
    """Sample + temporal EMA accumulate; returns (new_film, image f32[3,H,W])."""
    frame = jnp.where(jnp.asarray(dirty), jnp.uint32(0), film.frame)
    sample = render_sample_chw(scene, camera, settings, cfg, frame)
    new_film = film_ops.accumulate(film, sample, dirty)
    return new_film, new_film.accum


@partial(jax.jit, static_argnames=("settings", "cfg"), donate_argnames=("film",))
def render_frame_jit(scene, camera, settings, cfg, film, dirty):
    """Jitted steady-state frame step.  ``film`` is donated — the accumulation
    buffer is updated in place on device, the analog of the reference's
    per-frame ring of storage images (rvpt.h:193-215)."""
    return render_frame(scene, camera, settings, cfg, film, dirty)
